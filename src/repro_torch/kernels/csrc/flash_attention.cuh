// Tile shape shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu) kernels: one thread block of 8 warps
// takes 64 query rows (8 per warp) and walks 32-key tiles (one key per lane),
// with K (and V) staged transposed in rows padded to 33 floats so the
// lane-per-key loops are free of bank conflicts.
#pragma once

#include "common.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per thread block
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr int kKtLd = kBK + 1;        // padded row of the transposed K tile
constexpr int kThreads = kWarps * 32;

}  // namespace

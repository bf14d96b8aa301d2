"""RMSNorm forward and backward: the CUDA kernels' wrapper.

Counterpart of ``repro/kernels/rmsnorm.py:rmsnorm``; the kernels are
``csrc/rmsnorm.cu``. A CPU tensor takes the plain version
``kernels/ref.py:rmsnorm_ref``, whose gradient is autograd's. A CUDA tensor
launches a forward kernel (or raises): the register path for aligned rows
of up to 256 vectors of 16 bytes (those of more than 32 vectors only when
there are at least 1024 rows), a block a row for any other, both with the
same bits (:func:`fwd_register_path`). When autograd needs a gradient it
goes through :class:`RMSNormFn`, whose forward also writes each row's
``rsqrt(mean(x^2) + eps)`` and whose backward launches the hand-written
backward kernels (the reference differentiates XLA's ops, so the backward
has no TPU kernel to mirror).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

# Launches in this process: ``launches`` counts the forward kernel,
# ``bwd_launches`` the backward (one per backward pass, which runs the dx
# and the dscale column-sum kernels). Each wrapper adds one where it
# launches and nowhere else; a caller may reset them to 0.
launches = 0
bwd_launches = 0

# The backward's grid, and so the rows of its dscale workspace: a block
# for every BWD_BLOCK_ELEMS elements, at most one an SM of the H100's 132
# (each block takes a contiguous run of rows).
BWD_MAX_BLOCKS, BWD_BLOCK_ELEMS = 132, 16384
# Rows of more than 256 vectors of 16 bytes take a block a row, with an fp32
# dscale accumulator a column in shared memory.
MAX_BWD_D = 12 * 1024
# The forward's register path (rows of at most FWD_MAX_VECS vectors of 16
# bytes, 16-byte aligned): a block of 4 warps for every FWD_BLOCK_ELEMS
# elements, at most four an SM (each block takes a contiguous run of rows).
# A row of more than 32 vectors is one warp's serial stream of work; with
# fewer than FWD_MIN_WIDE_ROWS such rows (a 512-token prefill, a decode
# step) the block-a-row kernel, which spreads a row over a block, finishes
# sooner (chip_smoke.py times both kernels at those shapes).
FWD_MAX_BLOCKS, FWD_BLOCK_ELEMS, FWD_MAX_VECS = 4 * 132, 2048, 256
FWD_MIN_WIDE_ROWS = 1024


def bwd_blocks(rows: int, D: int) -> int:
    """The backward's grid: a function of the shape alone."""
    return max(1, min(BWD_MAX_BLOCKS, -(-rows * D // BWD_BLOCK_ELEMS)))


def fwd_blocks(rows: int, D: int) -> int:
    """The register-path forward's grid: a function of the shape alone."""
    return max(1, min(FWD_MAX_BLOCKS, -(-rows * D // FWD_BLOCK_ELEMS)))


def fwd_register_path(x: torch.Tensor) -> bool:
    """Whether the forward takes the register path: rows of whole 16-byte
    vectors, at most FWD_MAX_VECS of them (and at least FWD_MIN_WIDE_ROWS
    rows where a row has more than 32), from a 16-byte aligned x (the output
    is a fresh allocation). Other rows take a block a row."""
    vec = 16 // x.element_size()
    D = x.shape[-1]
    nvec, rows = D // vec, x.numel() // max(D, 1)
    return (D % vec == 0 and nvec <= FWD_MAX_VECS and x.data_ptr() % 16 == 0
            and (nvec <= 32 or rows >= FWD_MIN_WIDE_ROWS))


def _check_cuda(x, scale, *more) -> None:
    ts = (x, scale) + more
    if any(t.device != x.device for t in ts):
        raise ValueError("rmsnorm: all tensors must be on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype for t in more):
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x (and dy) of one dtype, "
                        f"got {[t.dtype for t in (x,) + more]}")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes a float32 scale, got {scale.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rmsnorm kernel needs contiguous tensors")


def _launch_fwd(x, scale, eps, want_rstd):
    """Forward kernel -> (y in x.dtype, rstd fp32 (rows,) or None)."""
    global launches
    _check_cuda(x, scale)
    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty_like(x)
    rstd = (torch.empty((rows,), dtype=torch.float32, device=x.device)
            if want_rstd else None)
    if rows == 0:
        return out, rstd
    args = (x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rstd.data_ptr() if rstd is not None else None,
            _build.DTYPE_CODES[x.dtype], rows, D, float(eps))
    card = (x.device.index or 0, _build.stream_ptr(x.device))
    if fwd_register_path(x):
        err = _build.lib().rmsnorm_fwd_launch(*args, fwd_blocks(rows, D), *card)
    else:
        err = _build.lib().rmsnorm_fwd_rowblock_launch(*args, *card)
    _build.check(err, "rmsnorm")
    launches += 1
    return out, rstd


def _launch_bwd(x, scale, rstd, dy):
    """Backward kernels -> (dx in x.dtype, dscale fp32 (D,))."""
    global bwd_launches
    _check_cuda(x, scale, dy)
    D = x.shape[-1]
    rows = x.numel() // D
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    if rstd.dtype != torch.float32 or tuple(rstd.shape) != (rows,) or not rstd.is_contiguous():
        raise ValueError("rmsnorm backward needs the forward's fp32 (rows,) rstd")
    if D > MAX_BWD_D:
        raise ValueError(f"rmsnorm backward kernel takes D <= {MAX_BWD_D}, got {D}")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty((D,), dtype=torch.float32, device=x.device)
    nblocks = bwd_blocks(rows, D)
    partial = torch.empty((nblocks, D), dtype=torch.float32, device=x.device)
    err = _build.lib().rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), _build.DTYPE_CODES[x.dtype], rows, D,
        nblocks, x.device.index or 0, _build.stream_ptr(x.device))
    _build.check(err, "rmsnorm backward")
    bwd_launches += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """RMSNorm whose forward and backward are the hand-written kernels.

    The forward keeps x, the scale and the fp32 per-row rstd.
    """

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rstd = _launch_fwd(x, scale, eps, want_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = _launch_bwd(x, scale, rstd, dy.contiguous())
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x (..., D), scale (D,) -> (..., D) in x.dtype."""
    if scale.dim() != 1 or x.dim() < 1 or x.shape[-1] != scale.shape[0]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and scale {tuple(scale.shape)} "
                         f"do not match")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, float(eps))
    return _launch_fwd(x, scale, eps, want_rstd=False)[0]

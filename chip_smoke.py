#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. It imports the port
(``src/repro_torch``) and nothing of JAX or of the reference package. Each
phase prints one JSON line; any failure ends the run with a non-zero exit
and no result line:

1. ``build``: the card's name and power limit (``nvidia-smi``), then one
   ``nvcc`` build of every kernel source in the checkout.
2. ``kernels``: every kernel against its plain PyTorch version on the card,
   at the GPT-2 XL shapes of the serving path and at edge shapes
   (GQA/MQA, window, softcap, fp32, empty slots, ragged sizes). Tolerances:
   quantize bit for bit; attention 1e-4 in fp32, and 2e-2 absolute in bf16
   at unit-scale outputs (one bf16 rounding of the output, about 4e-3 there,
   plus another summation order). Device times (CUDA events, median of 25
   runs, L2 flushed and the launch queued behind a sleep kernel so host
   overhead is not counted) beside the plain version's and, for attention,
   ``F.scaled_dot_product_attention`` as a yardstick the port never calls.
3. ``e2e_vs_cpu``: GPT-2 XL width at 4 layers in fp32, the same seeded
   weights on the card (kernels) and on the CPU (plain versions): a
   teacher-forced paged rollout (prompt 200, 16 decode steps) must agree
   within 1e-3 on every logit; the card's int8-KV rollout must lie within
   2% of max |logit| of its fp32 rollout (the reference's int8 tolerance).
4. ``serve``: full GPT-2 XL (48 layers, bf16, random seeded weights)
   through ``ServeEngine`` as the launcher builds it: 8 requests (prompts
   128/256/384/512, twice), 32 new tokens each, 4 slots, block 16, greedy,
   once with bf16 KV and once with int8 KV. The launch counters are set to
   0 just before each run and must show every kernel of the path ran:
   flash = prefills x 48, decode = decode steps x 48, quantize = 2 x 48 x
   (prefills + decode steps) with int8 KV and 0 without.
5. ``breakdown``: device time by kernel group (``torch.profiler``) beside
   the host's wall time, for one 512-token prefill and for decode steps
   over 4 slots of the bf16 serve path; the device's idle share is one
   minus their ratio.
6. a ``{"kernels": [...]}`` line: per kernel its launches on the serve runs,
   max error, kernel / plain / library times and the bound at the main
   path's shape (bytes over 3.35 TB/s and operations over the peak rate of
   the inputs' type, the larger of the two; H100 SXM data sheet).
7. the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
NUM_LAYERS_XL = 48
REPS = 25
SLEEP_CYCLES = 4_000_000             # ~2 ms: covers the host's enqueue time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Timer:
    """Device time of a callable with CUDA events, host overhead excluded.

    Each run flushes L2 (a 64 MB write), queues a sleep kernel so the host
    can enqueue the timed work behind it, and records events around the
    work alone; the result is the median over the runs, in ms.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()  # warm up (allocator, first-launch attribute setting)
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_quantize(torch, timer, results):
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels.ref import quantize_blockwise_ref

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # name, n, dtype, bits, block
        ("decode_kv_rows_bf16", 4 * 25 * 64, torch.bfloat16, 8, 64),
        ("prefill_kv_rows_bf16", 512 * 25 * 64, torch.bfloat16, 8, 64),
        ("prefill_kv_rows_f32", 512 * 25 * 64, torch.float32, 8, 64),
        ("outer_block256_ragged", 100_003, torch.float32, 8, 256),
        ("int4_block256", 65_536, torch.float32, 4, 256),
    ]
    worst = 0.0
    for name, n, dt, bits, block in cases:
        x = torch.randn(n, generator=g, device="cuda").to(dt)
        if name == "outer_block256_ragged":
            x[:block * 3] = 0  # whole zero blocks: scale 0, values 0
        q, s = QK.quantize_blockwise(x, bits=bits, block=block)
        qr, sr = quantize_blockwise_ref(x, bits=bits, block=block)
        torch.cuda.synchronize()
        same = torch.equal(q, qr) and torch.equal(s, sr)
        err = max(max_err(q, qr), max_err(s, sr))
        emit({"phase": "kernels", "kernel": "quantize_blockwise", "case": name,
              "n": n, "dtype": str(dt).replace("torch.", ""), "bits": bits,
              "block": block, "bitwise_equal": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"quantize {name}: kernel != plain version (err {err})")
        worst = max(worst, err)

    # main path's shape: one prefill layer's K rows (S=512, 25 heads, hd 64)
    x = torch.randn(512 * 25 * 64, generator=g, device="cuda").to(torch.bfloat16)
    t_k = timer.ms(lambda: QK.quantize_blockwise(x, bits=8, block=64))
    t_p = timer.ms(lambda: quantize_blockwise_ref(x, bits=8, block=64))
    n = x.numel()
    nbytes = n * 2 + n * 1 + (n // 64) * 4
    b, by = bound_ms(nbytes, 4 * n, "float32")
    results["quantize_blockwise"] = {
        "name": "quantize_blockwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:35",
        "shape": "bf16 (512*25*64,) block 64 (one prefill layer's K rows)",
        "max_abs_err": worst, "ms": t_k, "kernel_ms": t_k, "plain_ms": t_p,
        "bound_ms": b, "bound_by": by, "library_ms": None}


def check_flash(torch, timer, results):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels.ref import flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    cases = [
        # name, B, S, H, Hkv, hd, dtype, causal, window, softcap
        ("xl_s128_bf16", 1, 128, 25, 25, 64, torch.bfloat16, True, 0, 0.0),
        ("xl_s512_bf16", 1, 512, 25, 25, 64, torch.bfloat16, True, 0, 0.0),
        ("xl_s700_bf16", 1, 700, 25, 25, 64, torch.bfloat16, True, 0, 0.0),
        ("xl_s512_f32", 1, 512, 25, 25, 64, torch.float32, True, 0, 0.0),
        ("gqa4_f32", 2, 200, 8, 2, 64, torch.float32, True, 0, 0.0),
        ("mqa_hd128_f32", 1, 100, 8, 1, 128, torch.float32, True, 0, 0.0),
        ("window64_f32", 1, 300, 4, 4, 64, torch.float32, True, 64, 0.0),
        ("softcap30_f32", 1, 257, 4, 2, 64, torch.float32, True, 0, 30.0),
        ("noncausal_f32", 2, 77, 4, 4, 64, torch.float32, False, 0, 0.0),
        ("hd256_f32", 1, 77, 2, 1, 256, torch.float32, True, 0, 0.0),
        ("hd40_s1_f32", 3, 1, 4, 4, 40, torch.float32, True, 0, 0.0),
        ("hd40_f32", 1, 45, 4, 2, 40, torch.float32, True, 16, 10.0),
    ]
    worst = 0.0
    for name, B, S, H, Hkv, hd, dt, causal, window, softcap in cases:
        q, k, v = rand((B, S, H, hd), dt), rand((B, S, Hkv, hd), dt), rand((B, S, Hkv, hd), dt)
        out = FK.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 1e-4 if dt == torch.float32 else 2e-2
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
              "dtype": str(dt).replace("torch.", ""), "causal": causal,
              "window": window, "softcap": softcap, "max_abs_err": err, "tol": tol})
        if not (out.dtype == q.dtype and err <= tol):
            raise AssertionError(f"flash {name}: max err {err} > {tol}")
        worst = max(worst, err)

    # main path's shape: the longest prompt's prefill attention in one layer
    B, S, H, hd = 1, 512, 25, 64
    q, k, v = (rand((B, S, H, hd), torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t_k = timer.ms(lambda: FK.flash_attention(q, k, v, causal=True))
    t_p = timer.ms(lambda: flash_attention_ref(q, k, v, causal=True))
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    nbytes = 4 * B * S * H * hd * 2
    ops = 4 * hd * H * B * (S * (S + 1) // 2)  # QK^T and PV over unmasked pairs
    b, by = bound_ms(nbytes, ops, "bfloat16")
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42",
        "shape": "bf16 B=1 S=512 H=Hkv=25 hd=64 causal (one prefill layer)",
        "max_abs_err": worst, "ms": t_k, "kernel_ms": t_k, "plain_ms": t_p,
        "bound_ms": b, "bound_by": by, "library_ms": t_l}


def _paged_inputs(torch, g, *, B, H, Hkv, hd, bs, cls, dt, quantized, T=None):
    """Random q and pools; each sequence gets distinct shuffled blocks."""
    from repro_torch.kernels import quantize as QK

    need = [-(-c // bs) for c in cls]
    T = T or max(max(need), 1)
    N = sum(need) + 3
    perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
    tables = torch.full((B, T), -1, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    context = torch.tensor(cls, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    kf = torch.randn((N, bs, Hkv, hd), generator=g, device="cuda")
    vf = torch.randn((N, bs, Hkv, hd), generator=g, device="cuda")
    if quantized:
        def q8(x):
            qv, s = QK.quantize_blockwise(x.reshape(-1), bits=8, block=hd)
            return qv.reshape(x.shape), s.reshape(x.shape[:-1])
        (kp, ks), (vp, vs) = q8(kf), q8(vf)
        return q, kp, vp, tables, context, ks, vs
    return q, kf.to(dt), vf.to(dt), tables, context, None, None


def check_decode(torch, timer, results):
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels.ref import paged_decode_attention_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    xl_cls = [100, 250, 400, 544]
    cases = [
        # name, B, H, Hkv, hd, bs, cls, dtype, quantized, window, softcap
        ("xl_4slots_bf16", 4, 25, 25, 64, 16, xl_cls, torch.bfloat16, False, 0, 0.0),
        ("xl_4slots_int8", 4, 25, 25, 64, 16, xl_cls, torch.bfloat16, True, 0, 0.0),
        ("xl_4slots_f32", 4, 25, 25, 64, 16, xl_cls, torch.float32, False, 0, 0.0),
        ("xl_int8_f32q", 4, 25, 25, 64, 16, xl_cls, torch.float32, True, 0, 0.0),
        ("gqa4_f32", 3, 8, 2, 64, 16, [37, 1, 300], torch.float32, False, 0, 0.0),
        ("mqa_f32", 2, 8, 1, 32, 8, [60, 17], torch.float32, False, 0, 0.0),
        ("window40_f32", 2, 4, 2, 64, 16, [200, 33], torch.float32, False, 40, 0.0),
        ("softcap30_f32", 2, 4, 2, 64, 16, [90, 129], torch.float32, False, 0, 30.0),
        ("empty_slots_f32", 4, 4, 4, 64, 16, [0, 70, 0, 5], torch.float32, False, 0, 0.0),
        ("bs7_hd40_f32", 2, 6, 3, 40, 7, [50, 13], torch.float32, False, 0, 0.0),
        ("hd256_g16_f32", 1, 16, 1, 256, 16, [333], torch.float32, False, 0, 0.0),
    ]
    worst = 0.0
    for name, B, H, Hkv, hd, bs, cls, dt, quant, window, softcap in cases:
        args = _paged_inputs(torch, g, B=B, H=H, Hkv=Hkv, hd=hd, bs=bs, cls=cls,
                             dt=dt, quantized=quant,
                             T=None if name != "empty_slots_f32" else 8)
        out = DK.paged_decode_attention(*args, window=window, softcap=softcap)
        ref = paged_decode_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 1e-4 if dt == torch.float32 else 2e-2
        zeros_ok = all(float(out[b].abs().max()) == 0.0 for b in range(B) if cls[b] == 0)
        emit({"phase": "kernels", "kernel": "paged_decode_attention", "case": name,
              "B": B, "H": H, "Hkv": Hkv, "hd": hd, "bs": bs, "context_lens": cls,
              "dtype": str(dt).replace("torch.", ""), "int8_pools": quant,
              "window": window, "softcap": softcap, "max_abs_err": err, "tol": tol,
              "empty_slots_zero": zeros_ok})
        if not (out.dtype == dt and err <= tol and zeros_ok):
            raise AssertionError(f"decode {name}: max err {err} > {tol} or nonzero empty slot")
        worst = max(worst, err)

    # main path's shape: one decode step of one layer, 4 slots, bf16 pools
    args = _paged_inputs(torch, g, B=4, H=25, Hkv=25, hd=64, bs=16, cls=xl_cls,
                         dt=torch.bfloat16, quantized=False, T=34)
    t_k = timer.ms(lambda: DK.paged_decode_attention(*args))
    t_p = timer.ms(lambda: paged_decode_attention_ref(*args))
    args8 = _paged_inputs(torch, g, B=4, H=25, Hkv=25, hd=64, bs=16, cls=xl_cls,
                          dt=torch.bfloat16, quantized=True, T=34)
    t_k8 = timer.ms(lambda: DK.paged_decode_attention(*args8))
    pos, H, hd = sum(xl_cls), 25, 64
    nbytes = 2 * pos * H * hd * 2 + 2 * 4 * H * hd * 2 + 4 * 34 * 4 + 4 * 4
    b, by = bound_ms(nbytes, 4 * pos * H * hd, "bfloat16")
    nbytes8 = 2 * pos * H * (hd + 4) + 2 * 4 * H * hd * 2 + 4 * 34 * 4 + 4 * 4
    b8, _ = bound_ms(nbytes8, 4 * pos * H * hd, "bfloat16")
    results["paged_decode_attention"] = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:64",
        "shape": "bf16 4 slots, contexts 100/250/400/544, bs 16, H=Hkv=25, hd 64 (one layer)",
        "max_abs_err": worst, "ms": t_k, "kernel_ms": t_k, "plain_ms": t_p,
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "int8_pools_ms": t_k8, "int8_pools_bound_ms": b8}


# ---------------------------------------------------------------------------
# phase 3: card vs CPU, teacher-forced paged rollout
# ---------------------------------------------------------------------------


def rollout(torch, params, cfg, toks, S, D, pcfg, device):
    """Teacher-forced paged prefill + D decode steps -> (D + 1, V) logits."""
    from repro_torch.parallel.steps import build_paged_serve_steps

    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device=device)
    pools = bundle.init_pools()
    bs = pcfg.block_size
    pad = (-S) % bs
    n_blocks = pcfg.blocks_for(S + pad + D)
    table = torch.arange(1, 1 + n_blocks, dtype=torch.int32, device=device)
    prompt = torch.zeros((1, S + pad), dtype=torch.int32, device=device)
    prompt[0, :S] = toks[:S].to(device)
    lg, pools = bundle.prefill_step(params, prompt, pools, table[: (S + pad) // bs], S - 1)
    out = [lg[0].float().cpu()]
    for t in range(D):
        pos = S + t
        lg, pools = bundle.decode_step(
            params, pools, toks[pos:pos + 1].to(device),
            torch.tensor([pos], dtype=torch.int32, device=device), table[None],
            torch.tensor([pos + 1], dtype=torch.int32, device=device))
        out.append(lg[0].float().cpu())
    return torch.stack(out)


def e2e_vs_cpu(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serve.kv_cache import PagedCacheConfig

    cfg = get_config("gpt2-xl").replace(num_layers=4, dtype="float32")
    S, D = 200, 16
    t0 = time.perf_counter()
    params_cpu = R.init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (S + D,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    pcfg = PagedCacheConfig(num_blocks=32, block_size=16, dtype="float32")
    for c in counters.values():
        c.launches = 0
    card = rollout(torch, params_gpu, cfg, toks, S, D, pcfg, "cuda")
    launches = {k: c.launches for k, c in counters.items()}
    cpu = rollout(torch, params_cpu, cfg, toks, S, D, pcfg, "cpu")
    err = float((card - cpu).abs().max())
    q8 = rollout(torch, params_gpu, cfg, toks, S, D,
                 dataclasses.replace(pcfg, quantized=True), "cuda")
    err8 = float((q8 - card).abs().max())
    lim8 = 0.02 * float(card.abs().max())
    emit({"phase": "e2e_vs_cpu", "config": "gpt2-xl width, 4 layers, float32",
          "prompt": S, "decode_steps": D, "max_abs_logit_err_card_vs_cpu": err,
          "tol": 1e-3, "max_abs_logit": float(card.abs().max()),
          "int8_vs_fp32_max_abs_err": err8, "int8_tol": lim8,
          "greedy_agree_int8": float((q8.argmax(-1) == card.argmax(-1)).float().mean()),
          "card_launches": launches, "seconds": time.perf_counter() - t0})
    if not (torch.isfinite(card).all() and card.shape == (D + 1, cfg.vocab_size)):
        raise AssertionError("card rollout: non-finite logits or wrong shape")
    if err > 1e-3:
        raise AssertionError(f"card vs cpu logits differ by {err} > 1e-3")
    if err8 > lim8:
        raise AssertionError(f"int8 KV logits differ by {err8} > {lim8}")
    L = cfg.num_layers
    if launches != {"flash_attention": L, "paged_decode_attention": D * L,
                    "quantize_blockwise": 0}:
        raise AssertionError(f"card rollout launches {launches}")


# ---------------------------------------------------------------------------
# phase 4: full GPT-2 XL through the engine
# ---------------------------------------------------------------------------


def serve(torch, params, cfg, counters, *, quantized: bool):
    import numpy as np

    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import EngineConfig, PagedCacheConfig, ServeEngine

    slots, new_tokens, bs = 4, 32, 16
    lens = [128, 256, 384, 512] * 2
    need = -(-(max(lens) + new_tokens) // bs)  # blocks per sequence
    pcfg = PagedCacheConfig(num_blocks=need * slots + 1, block_size=bs,
                            quantized=quantized)
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cuda")
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args):
            t0 = time.perf_counter()
            logits, pools = fn(*args)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{kind}: non-finite logits")
            return logits, pools
        return call

    bundle = dataclasses.replace(
        bundle, prefill_step=timed("prefill", bundle.prefill_step),
        decode_step=timed("decode", bundle.decode_step))
    ecfg = EngineConfig(max_slots=slots, max_new_tokens=new_tokens, greedy=True,
                        max_blocks_per_seq=need)
    rng = np.random.default_rng(5)

    # warm-up request (cuBLAS handles, allocator); not counted
    warm = ServeEngine(params, cfg, bundle, pcfg, ecfg)
    warm.submit(rng.integers(0, cfg.vocab_size, size=16), 2)
    warm.run()
    torch.cuda.synchronize()
    times["prefill"].clear()
    times["decode"].clear()

    engine = ServeEngine(params, cfg, bundle, pcfg, ecfg)
    for n in lens:
        engine.submit(rng.integers(0, cfg.vocab_size, size=n), new_tokens, arrival=0.0)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    st = engine.stats
    ttft = sorted(r.first_token_at - t0 for r in results)
    dec = sorted(1e3 * t for t in times["decode"])
    line = {
        "phase": "serve", "kv": "int8" if quantized else "bf16",
        "config": "gpt2-xl 48 layers bf16", "requests": len(lens),
        "prompt_lens": lens, "new_tokens": new_tokens, "slots": slots,
        "block_size": bs, "wall_s": wall, "tokens_out": st["tokens_out"],
        "tokens_per_s": st["tokens_out"] / wall,
        "ttft_ms_p50": 1e3 * statistics.median(ttft), "ttft_ms_max": 1e3 * ttft[-1],
        "prefill_ms_p50": 1e3 * statistics.median(times["prefill"]),
        "decode_step_ms_p50": statistics.median(dec),
        "decode_step_ms_p99": dec[min(len(dec) - 1, math.ceil(0.99 * len(dec)) - 1)],
        "prefills": st["prefills"], "decode_steps": st["decode_steps"],
        "peak_blocks": st["peak_blocks"], "pool_blocks": pcfg.num_blocks - 1,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
    }
    emit(line)
    L = NUM_LAYERS_XL
    want_q = 2 * L * (st["prefills"] + st["decode_steps"]) if quantized else 0
    expect = {"flash_attention": st["prefills"] * L,
              "paged_decode_attention": st["decode_steps"] * L,
              "quantize_blockwise": want_q}
    if launches != expect:
        raise AssertionError(f"launch counters {launches} != expected {expect}")
    if st["prefills"] != len(lens) or st["decode_steps"] == 0:
        raise AssertionError(f"engine stats {st}")
    for r in results:
        if len(r.tokens) != new_tokens or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    return line


# ---------------------------------------------------------------------------
# phase 5: where the device time of one prefill and one decode step goes
# ---------------------------------------------------------------------------


def _kernel_group(name: str) -> str:
    for key, group in (("flash_fwd", "flash_attention"),
                       ("paged_decode", "paged_decode_attention"),
                       ("quantize_blockwise", "quantize_blockwise")):
        if key in name:
            return group
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def breakdown(torch, params, cfg):
    """Device time by kernel group (``torch.profiler``) beside the host's
    wall time, for the bf16 serve path at the serve phase's shapes: one
    512-token prefill, and decode steps over 4 slots at contexts
    128/256/384/512. Wall times come from a separate unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import PagedCacheConfig

    lens, steps, bs = [128, 256, 384, 512], 8, 16
    need = -(-(max(lens) + steps) // bs)
    pcfg = PagedCacheConfig(num_blocks=need * len(lens) + 1, block_size=bs)
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cuda")
    pools = bundle.init_pools()
    g = torch.Generator(device="cuda").manual_seed(6)
    tables = (1 + torch.arange(len(lens) * need, device="cuda", dtype=torch.int32)
              ).reshape(len(lens), need)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda",
                             dtype=torch.int32) for n in lens]
    tok = torch.zeros(len(lens), dtype=torch.int32, device="cuda")
    start = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def prefill_all():
        for i, n in enumerate(lens):
            bundle.prefill_step(params, prompts[i], pools, tables[i, :n // bs], n - 1)

    def decode_all():
        pos = start.clone()
        for _ in range(steps):
            bundle.decode_step(params, pools, tok, pos, tables, pos + 1)
            pos += 1

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    out = {}
    for kind, fn, count in (("prefill_512", lambda: bundle.prefill_step(
            params, prompts[-1], pools, tables[-1, :512 // bs], 511), 1),
            ("decode_step", decode_all, steps)):
        prefill_all()  # the pools hold every prompt before any timing
        wall = wall_ms(fn) / count
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups, n_kernels = {}, 0
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                grp = _kernel_group(evt.name)
                groups[grp] = groups.get(grp, 0.0) + evt.time_range.elapsed_us() / 1e3 / count
                n_kernels += 1
        busy = sum(groups.values())
        out[kind] = {"wall_ms": wall,
                     "device_ms": busy if n_kernels else "not measured",
                     "device_idle_share": 1 - busy / wall if n_kernels else "not measured",
                     "kernels_per_call": n_kernels / count,
                     "device_ms_by_group": groups}
    emit({"phase": "breakdown", "config": "gpt2-xl 48 layers bf16, bf16 KV",
          "decode_slots": len(lens), "decode_contexts": lens, **out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets full-fp32 matmul flags)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import quantize as QK

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.lib()
    emit({"phase": "build", "seconds": _build.build_seconds,
          "library": str(_build.library_path().relative_to(ROOT)),
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    counters = {"flash_attention": FK, "paged_decode_attention": DK,
                "quantize_blockwise": QK}
    timer = Timer(torch)
    results = {}
    check_quantize(torch, timer, results)
    check_flash(torch, timer, results)
    check_decode(torch, timer, results)
    del timer

    e2e_vs_cpu(torch, counters)

    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config("gpt2-xl")
    params = R.init_params(cfg, seed=0, device="cuda")
    runs = [serve(torch, params, cfg, counters, quantized=q) for q in (False, True)]
    breakdown(torch, params, cfg)

    kernels = []
    for name in ("flash_attention", "paged_decode_attention", "quantize_blockwise"):
        entry = dict(results[name])
        entry["launches"] = sum(r["launches"][name] for r in runs)
        kernels.append(entry)
    emit({"phase": "done", "card": smi, "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

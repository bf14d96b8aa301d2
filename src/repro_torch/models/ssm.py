"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro/models/ssm.py`` [arXiv:2405.04517], with the same
parameter names, layouts and numerics. mLSTM has two equal forms for a
whole sequence, the stabilized quadratic one (:func:`mlstm_parallel`) and
the chunkwise one (:func:`mlstm_chunkwise`, chosen as the reference
chooses), a closed form of the state at the sequence's end
(:func:`mlstm_final_state`, which the prefill hands to decode), and the
recurrent step of decode. sLSTM has recurrent connections through the
previous ``h``, so its prefill is a loop over the sequence in Python: one
step's handful of kernels per position, which the host issues one by one.

The reference runs all of this outside any Pallas kernel, so the port runs
plain PyTorch here, on either device, and trains through autograd as the
reference differentiates its scans. The stabilizers start at ``-inf`` and
the causal masks are ``-inf``: every ``exp`` of them gives 0, never NaN,
because each row's maximum includes its own diagonal term, and so do
their gradients. Maxima are ``torch.maximum``, whose gradient splits a tie
half and half as ``jnp.maximum``'s does (``torch.clamp_min`` would pass
all of it), and ``|x|`` has a zero gradient at 0 in both.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

PF = 2  # mLSTM up-projection factor


def _group_norm(h, scale, eps=1e-6):
    """Per-head RMS norm. h: (..., H, dh), scale: (H, dh)."""
    hf = h.float()
    ms = hf.square().mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(ms + eps) * scale.float()).to(h.dtype)


def _causal_conv1d(x, kernel, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, C); kernel: (W, C).

    With ``state`` ((B, W-1, C) trailing inputs) performs a streaming step and
    returns (y, new_state); without, (y, None).
    """
    W, S = kernel.shape[0], x.shape[1]
    if state is not None:
        ctx = torch.cat([state, x], dim=1)  # (B, W-1+S, C)
        y = sum(ctx[:, i:i + S] * kernel[i] for i in range(W))
        return y, (ctx[:, -(W - 1):] if W > 1 else state)
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S] * kernel[i] for i in range(W)), None


def _tril(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).tril()


# ===========================================================================
# mLSTM
# ===========================================================================


def init_mlstm(gen: torch.Generator, cfg: ModelConfig):
    D = cfg.d_model
    Di = PF * D
    H = cfg.num_heads
    dh = Di // H
    dev = gen.device
    return {
        "w_up": L.dense_init(gen, (D, 2 * Di)),
        "conv": L.dense_init(gen, (cfg.conv1d_width, Di), 0.1),
        # block-diagonal (per-head) q/k/v projections, as in official xLSTM
        "wq": L.dense_init(gen, (H, dh, dh)),
        "wk": L.dense_init(gen, (H, dh, dh)),
        "wv": L.dense_init(gen, (H, dh, dh)),
        "w_igate": L.dense_init(gen, (Di, H), 0.01),
        "b_igate": torch.full((H,), -3.0, device=dev),  # mostly-closed input gate
        "w_fgate": L.dense_init(gen, (Di, H), 0.01),
        "b_fgate": torch.full((H,), 3.0, device=dev),  # mostly-open forget gate
        "out_norm": torch.ones((H, dh), device=dev),
        "w_down": L.out_proj_init(gen, (Di, D), cfg.num_layers),
    }


def _heads(x, w):
    """Per-head projection: x (B, S, H, e) @ w (H, e, f) -> (B, S, H, f)."""
    return torch.einsum("bshe,hef->bshf", x, w)


def _mlstm_qkv_gates(p, x, cfg: ModelConfig, conv_state=None):
    Di = PF * cfg.d_model
    H = cfg.num_heads
    up = x @ L.cast(p["w_up"], cfg)
    z, m_in = up[..., :Di], up[..., Di:]
    m_c, new_conv_state = _causal_conv1d(m_in, L.cast(p["conv"], cfg), conv_state)
    m_c = F.silu(m_c)
    B, S = x.shape[:2]
    dh = Di // H
    m_c_h = m_c.reshape(B, S, H, dh)
    m_in_h = m_in.reshape(B, S, H, dh)
    q = _heads(m_c_h, L.cast(p["wq"], cfg))
    k = _heads(m_c_h, L.cast(p["wk"], cfg))
    v = _heads(m_in_h, L.cast(p["wv"], cfg))
    # gate pre-activations (fp32 for stability)
    m_f = m_c.float()
    ig = m_f @ p["w_igate"].float() + p["b_igate"].float()
    fg = m_f @ p["w_fgate"].float() + p["b_fgate"].float()
    return z, q, k, v, ig, fg, new_conv_state


def mlstm_parallel(q, k, v, ig, fg):
    """Stabilized quadratic mLSTM. q/k/v: (B,S,H,dh); ig/fg: (B,S,H) logits.

    Returns h: (B,S,H,dh) in q's dtype.
    """
    B, S, H, dh = q.shape
    qf = q.float()
    kf = k.float() / math.sqrt(dh)
    vf = v.float()
    Fc = torch.cumsum(F.logsigmoid(fg.float()), dim=1)  # (B,S,H) inclusive
    # D_ij = F_i - F_j + i~_j for j <= i
    Dm = Fc[:, :, None, :] - Fc[:, None, :, :] + ig.float()[:, None, :, :]  # (B,Si,Sj,H)
    Dm = Dm.masked_fill(~_tril(S, q.device)[None, :, :, None], -math.inf)
    m = Dm.amax(dim=2)  # (B,Si,H): finite, the diagonal is never masked
    Dp = torch.exp(Dm - m[:, :, None, :])
    scores = torch.einsum("bihd,bjhd->bijh", qf, kf) * Dp
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))  # (B,Si,H)
    h = torch.einsum("bijh,bjhd->bihd", scores, vf) / norm[..., None]
    return h.to(q.dtype)


def mlstm_recurrent_step(state, q, k, v, ig, fg):
    """One decode step. state = (C, n, m); q/k/v: (B,H,dh); ig/fg: (B,H)."""
    C, n, m_prev = state
    dh = q.shape[-1]
    qf = q.float()
    kf = k.float() / math.sqrt(dh)
    vf = v.float()
    ig = ig.float()
    log_f = F.logsigmoid(fg.float())
    m_new = torch.maximum(log_f + m_prev, ig)
    f_sc = torch.exp(log_f + m_prev - m_new)[..., None]
    i_sc = torch.exp(ig - m_new)[..., None]
    C_new = f_sc[..., None] * C + i_sc[..., None] * (kf[..., :, None] * vf[..., None, :])
    n_new = f_sc * n + i_sc * kf
    num = torch.einsum("bhkv,bhk->bhv", C_new, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qf).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return (C_new, n_new, m_new), h


def _outer_sum(w, k, v):
    """sum_s w[b,s,h] k[b,s,h,:]^T v[b,s,h,:] -> (B,H,dk,dv), as one batched
    matmul of (w k)^T and v per head: never the (B,S,H,dk,dv) products."""
    return torch.einsum("bshd,bshk->bhdk", w[..., None] * k, v)


def mlstm_final_state(q, k, v, ig, fg):
    """Closed-form end-of-sequence recurrent state (C, n, m).

    Equals running :func:`mlstm_recurrent_step` over the sequence:
    m_S = max_j (F_S - F_j + i_j); C_S = sum_j e^{b_j - m_S} k_j v_j^T.
    """
    dh = q.shape[-1]
    kf = k.float() / math.sqrt(dh)
    vf = v.float()
    Fc = torch.cumsum(F.logsigmoid(fg.float()), dim=1)  # (B,S,H)
    b = Fc[:, -1:, :] - Fc + ig.float()  # (B,S,H)
    m = b.amax(dim=1)  # (B,H)
    w = torch.exp(b - m[:, None, :])  # (B,S,H)
    C = _outer_sum(w, kf, vf)
    n = torch.einsum("bsh,bshd->bhd", w, kf)
    return (C, n, m)


def mlstm_chunkwise(q, k, v, ig, fg, *, chunk: int):
    """Chunkwise-parallel mLSTM: intra-chunk quadratic + inter-chunk scan.

    Equal to :func:`mlstm_parallel`; O(S·c + S·dh²/c) instead of O(S²). The
    scan over the S / c chunks is a loop in Python.
    """
    B, S, H, dh = q.shape
    c = chunk
    assert S % c == 0, (S, c)
    N = S // c
    qf = q.float().reshape(B, N, c, H, dh)
    kf = (k.float() / math.sqrt(dh)).reshape(B, N, c, H, dh)
    vf = v.float().reshape(B, N, c, H, dh)
    igf = ig.float().reshape(B, N, c, H)
    log_f = F.logsigmoid(fg.float()).reshape(B, N, c, H)

    Fc = torch.cumsum(log_f, dim=2)  # within-chunk cumulative log-forget
    f_total = Fc[:, :, -1]  # (B,N,H) total chunk decay
    # b_j = F_total - F_j + i_j: weight of token j in the end-of-chunk state;
    # a_i = F_i: decay of the carry-in at position i
    b = f_total[:, :, None] - Fc + igf  # (B,N,c,H)
    causal = _tril(c, q.device)[None, :, :, None]

    C_prev = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n_prev = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H), -math.inf, dtype=torch.float32, device=q.device)
    hs = []
    for t in range(N):
        qc, kc, vc, bc, Fcc, igc = (x[:, t] for x in (qf, kf, vf, b, Fc, igf))
        # intra-chunk, as the parallel form, with a local stabilizer
        Dm = Fcc[:, :, None, :] - Fcc[:, None, :, :] + igc[:, None, :, :]
        Dm = Dm.masked_fill(~causal, -math.inf)
        m_local = Dm.amax(dim=2)  # (B,c,H)
        # carry-in from the chunks before: -inf at the first chunk, where
        # exp(m_in - m_i) is 0
        m_in = Fcc + m_prev[:, None, :]
        m_i = torch.maximum(m_local, m_in)
        Dp = torch.exp(Dm - m_i[:, :, None, :])
        scores = torch.einsum("bihd,bjhd->bijh", qc, kc) * Dp
        inter_q = qc * torch.exp(m_in - m_i)[..., None]  # decayed queries
        num = (torch.einsum("bijh,bjhd->bihd", scores, vc)
               + torch.einsum("bihd,bhdk->bihk", inter_q, C_prev))
        den_local = scores.sum(dim=2)  # (B,c,H)
        den_inter = torch.einsum("bihd,bhd->bih", inter_q, n_prev)
        den = torch.maximum((den_local + den_inter).abs(), torch.exp(-m_i))
        hs.append(num / den[..., None])
        # state at the end of the chunk
        ftot = f_total[:, t]
        m_next = torch.maximum(ftot + m_prev, bc.amax(dim=1))  # (B,H)
        carry = torch.exp(ftot + m_prev - m_next)  # (B,H)
        token_w = torch.exp(bc - m_next[:, None, :])  # (B,c,H)
        C_prev = carry[..., None, None] * C_prev + _outer_sum(token_w, kc, vc)
        n_prev = carry[..., None] * n_prev + torch.einsum("bjh,bjhd->bhd", token_w, kc)
        m_prev = m_next
    return torch.stack(hs, dim=1).reshape(B, S, H, dh).to(q.dtype)


def apply_mlstm(p, x, cfg: ModelConfig, *, state=None, return_state=False):
    """mLSTM block. state=None -> a whole sequence; else one decode step."""
    B, S = x.shape[:2]
    if state is None:
        z, q, k, v, ig, fg, _ = _mlstm_qkv_gates(p, x, cfg)
        if cfg.mlstm_chunk > 0 and S > cfg.mlstm_chunk and S % cfg.mlstm_chunk == 0:
            h = mlstm_chunkwise(q, k, v, ig, fg, chunk=cfg.mlstm_chunk)
        else:
            h = mlstm_parallel(q, k, v, ig, fg)
        new_state = None
        if return_state:
            Di = PF * cfg.d_model
            W = cfg.conv1d_width
            # the conv's trailing inputs: the up-projection's m half of the
            # last W-1 tokens
            m_tail = x[:, -(W - 1):] @ L.cast(p["w_up"], cfg)[:, Di:]
            new_state = {"cell": mlstm_final_state(q, k, v, ig, fg),
                         "conv": m_tail.to(L.compute_dtype(cfg))}
    else:
        z, q, k, v, ig, fg, new_conv = _mlstm_qkv_gates(p, x, cfg, conv_state=state["conv"])
        cell, h = mlstm_recurrent_step(state["cell"], q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                       fg[:, 0])
        h = h[:, None]
        new_state = {"cell": cell, "conv": new_conv}
    h = _group_norm(h, p["out_norm"]).reshape(B, S, -1)
    h = h * F.silu(z)
    return h @ L.cast(p["w_down"], cfg), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device):
    Di = PF * cfg.d_model
    H = cfg.num_heads
    dh = Di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "cell": (torch.zeros((batch, H, dh, dh), **f32), torch.zeros((batch, H, dh), **f32),
                 torch.full((batch, H), -math.inf, **f32)),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, Di), dtype=L.compute_dtype(cfg),
                            device=device),
    }


# ===========================================================================
# sLSTM
# ===========================================================================

_GATES = ("i", "f", "z", "o")


def init_slstm(gen: torch.Generator, cfg: ModelConfig):
    D = cfg.d_model
    H = cfg.num_heads
    dh = D // H
    dev = gen.device
    p = {f"w_{g}": L.dense_init(gen, (D, D)) for g in _GATES}
    # block-diagonal (per-head) recurrent matrices
    p.update({f"r_{g}": L.dense_init(gen, (H, dh, dh), 0.05) for g in _GATES})
    p.update({"b_i": torch.full((D,), -3.0, device=dev), "b_f": torch.full((D,), 3.0, device=dev),
              "b_z": torch.zeros((D,), device=dev), "b_o": torch.zeros((D,), device=dev),
              "out_norm": torch.ones((H, dh), device=dev),
              "w_down": L.out_proj_init(gen, (D, D), cfg.num_layers)})
    return p


def _recurrent_weights(p):
    """The four (H, dh, dh) recurrent matrices side by side, (H, dh, 4 dh),
    so that one batched matmul a step gives all four gates' terms."""
    return torch.cat([p[f"r_{g}"].float() for g in _GATES], dim=-1)


def _slstm_step(R, state, xi, xf, xz, xo, n_floor):
    """One step; ``n_floor`` is the normalizer's floor 1e-6 as a 0-dim fp32
    tensor on the state's device (``torch.maximum`` against it splits a
    tie's gradient as the reference's ``jnp.maximum(n, 1e-6)`` does)."""
    c, n, m_prev, h_prev = state
    rec = torch.einsum("bhk,hkd->bhd", h_prev, R)  # (B,H,4dh)
    ri, rf, rz, ro = rec.chunk(4, dim=-1)
    it, ft, zt, ot = xi + ri, xf + rf, xz + rz, xo + ro
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m_prev, it)
    i_sc = torch.exp(it - m_new)
    f_sc = torch.exp(log_f + m_prev - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(zt)
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(ot) * c_new / torch.maximum(n_new, n_floor)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_cell(p, cfg: ModelConfig, state, xi, xf, xz, xo):
    """One sLSTM step. state=(c,n,m,h) each (B,H,dh); x*: (B,H,dh) projections."""
    return _slstm_step(_recurrent_weights(p), state, xi, xf, xz, xo, _n_floor(xi))


def _n_floor(x):
    return x.new_full((), 1e-6, dtype=torch.float32)


def apply_slstm(p, x, cfg: ModelConfig, *, state=None, return_state=False):
    """sLSTM block: a loop over time (a whole sequence) or one decode step."""
    B, S, D = x.shape
    H = cfg.num_heads
    dh = D // H
    xf32 = x.float()
    xi, xf_, xz, xo = ((xf32 @ p[f"w_{g}"].float() + p[f"b_{g}"].float()).reshape(B, S, H, dh)
                       for g in _GATES)
    R = _recurrent_weights(p)
    floor = _n_floor(xf32)
    if state is None:
        cell = init_slstm_state(cfg, B, x.device)["cell"]
        hs = []
        for t in range(S):
            cell, h_t = _slstm_step(R, cell, xi[:, t], xf_[:, t], xz[:, t], xo[:, t], floor)
            hs.append(h_t)
        h = torch.stack(hs, dim=1)  # (B,S,H,dh)
        new_state = {"cell": cell} if return_state else None
    else:
        cell, h = _slstm_step(R, state["cell"], xi[:, 0], xf_[:, 0], xz[:, 0], xo[:, 0],
                              floor)
        h = h[:, None]
        new_state = {"cell": cell}
    h = _group_norm(h, p["out_norm"]).reshape(B, S, D)  # fp32
    # fp32 h against the cast weight: the reference's einsum promotes to fp32
    out = h @ L.cast(p["w_down"], cfg).float()
    return out.to(x.dtype), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    H = cfg.num_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"cell": (torch.zeros((batch, H, dh), **f32), torch.zeros((batch, H, dh), **f32),
                     torch.full((batch, H, dh), -30.0, **f32),
                     torch.zeros((batch, H, dh), **f32))}

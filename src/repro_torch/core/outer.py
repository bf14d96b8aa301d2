"""The Pier outer optimizer (Algorithms 1 and 2 of the paper).

Counterpart of ``repro/core/outer.py``. The outer "gradient" is the
averaged model delta ``Δθ = θ_t − θ_{t−r}``; the formulations
(``nesterov_torch``, ``nesterov_classic``, ``sgd``), the sign convention and
the dispatch/apply split of a delayed sync are the reference's:

- :func:`outer_reduce` consumes the averaged Δθ: it advances the momentum
  and produces the synchronized *target* ``θ_anchor + lr·step``, which is
  also the new anchor;
- :func:`outer_apply` installs the target ``sync_delay`` steps later with
  the stale-delta correction ``θ ← target + (θ_t − θ_dispatch)``.

Trees are lists of tensors in leaf order (``transformer.param_leaves``).
Where the reference builds new arrays, the port may update in place:
:func:`outer_reduce` with ``inplace=True`` writes the new momentum over the
old and the target over the anchor, through the pier-update kernel on CUDA
leaves. That holds only for fp32 outer state, where the reference's new
anchor is the target itself (cast to the state dtype, a no-op); the target
returned is then the anchor tensor, and nothing may write to it until the
next outer sync. With bf16 state the target is a separate fp32 tensor.

The compressed strategies carry an error-feedback residual per group
(``OuterState.residual``, and the rs/ag path's ``residual2``): one
``(G, *leaf.shape)`` fp32 tensor per leaf. :func:`compress_delta` is the
quantize-dequantize round trip with error feedback; on CUDA leaves it
launches the quantize and dequantize kernels through ``kernels.ops``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import torch_dtype


class OuterState(NamedTuple):
    momentum: List[torch.Tensor]  # M, in tc.opt_state_dtype
    anchor: List[torch.Tensor]  # θ_{t-r}: model snapshot at the last sync
    num_syncs: int  # how many outer steps have been taken
    # Error-feedback residual of the compressed outer collective: what
    # blockwise quantization dropped from each group's payload, re-injected
    # into its next Δθ. None without compression; else one fp32
    # (num_groups, *leaf.shape) tensor per leaf, a row per group (never
    # shared between groups).
    residual: Optional[List[torch.Tensor]] = None
    # The rs/ag wire path's second residual (what re-quantizing each
    # endpoint's reduced shard dropped), same layout; nonzero only on a
    # group's own slot. None unless the strategy's plan needs it.
    residual2: Optional[List[torch.Tensor]] = None


def outer_init(leaves, tc: TrainConfig, *, num_groups: int = 1,
               needs_residual: Optional[bool] = None,
               needs_residual2: bool = False) -> OuterState:
    """``leaves``: parameter tensors in leaf order. The anchor is a copy.

    ``needs_residual`` defaults from the config's compression; pass the
    strategy plan's own when a strategy is injected.
    """
    dt = torch_dtype(tc.opt_state_dtype)
    if needs_residual is None:
        needs_residual = tc.outer_comm.compression != "none"

    def zeros_g():
        return [torch.zeros((num_groups, *p.shape), dtype=torch.float32, device=p.device)
                for p in leaves]

    with torch.no_grad():
        return OuterState(
            momentum=[torch.zeros(p.shape, dtype=dt, device=p.device) for p in leaves],
            anchor=[p.detach().to(dt, copy=True) for p in leaves],
            num_syncs=0,
            residual=zeros_g() if needs_residual else None,
            residual2=zeros_g() if needs_residual2 else None)


@torch.no_grad()
def warmup_reduce(state: OuterState, leaves, mu) -> OuterState:
    """Algorithm 1, lines 5-6: Δθ = θ_t − θ_{t−r};  M ← μM + Δθ; anchor ← θ_t.

    The dispatch half of a warmup accumulate: a new (pending) state made
    from the dispatch-time ``leaves``; :func:`warmup_apply` installs it.
    ``mu`` is rounded to fp32 once, as the reference's traced scalar is.
    """
    sdt = state.momentum[0].dtype
    mu_t = torch.tensor(np.float32(mu), device=state.momentum[0].device)
    new_m = []
    for m, p, a in zip(state.momentum, leaves, state.anchor):
        delta = p.float() - a.float()
        new_m.append((mu_t * m.float() + delta).to(sdt))
    new_anchor = [p.detach().to(a.dtype, copy=True) for p, a in zip(leaves, state.anchor)]
    return state._replace(momentum=new_m, anchor=new_anchor, num_syncs=state.num_syncs + 1)


def warmup_apply(pending: OuterState) -> OuterState:
    """Install a dispatched warmup accumulation: the correction is
    identically zero (``repro/core/outer.py:warmup_apply`` says why)."""
    return pending


def warmup_accumulate(state: OuterState, leaves, mu) -> OuterState:
    """Eager fused warmup accumulate: reduce, then apply."""
    return warmup_apply(warmup_reduce(state, leaves, mu))


def quant_fns(*, bits: int, block: int):
    """(quantize, dequantize) callables for the outer payload, through the
    ``kernels.ops`` wrappers: a CUDA tensor launches the kernels, a CPU
    tensor runs their plain versions (the same functions bit for bit)."""
    return (lambda x: kops.quantize_blockwise(x, bits=bits, block=block),
            lambda q, s: kops.dequantize_blockwise(q, s, block=block))


@torch.no_grad()
def compress_leaf(d: torch.Tensor, r: Optional[torch.Tensor], *, bits: int, block: int):
    """One leaf of :func:`compress_delta` -> (payload fp32, new residual fp32).

    ``c = Δθ + r;  (q, s) = Q(c);  payload = DQ(q, s)[:n];  r' = c − payload``,
    so ``payload + r' == c`` exactly and the error telescopes.
    """
    quant, dequant = quant_fns(bits=bits, block=block)
    c = d.float()
    if r is not None:
        c = c + r.float()
    flat = c.reshape(-1)
    q, s = quant(flat)
    payload = dequant(q, s)[: flat.shape[0]].reshape(c.shape)
    return payload, c - payload


def compress_delta(delta, residual, tc: Optional[TrainConfig] = None, *,
                   bits: Optional[int] = None, block: Optional[int] = None):
    """Blockwise-quantize one group's Δθ leaves with error feedback.

    Counterpart of ``repro/core/outer.py:compress_delta`` on a list of
    leaves; ``residual=None`` is a zero residual (the first sync).
    ``bits``/``block`` default from ``tc.outer_comm``. Returns
    ``(payload_leaves_f32, new_residual_leaves_f32)``.
    """
    if bits is None:
        bits = tc.outer_comm.bits
    if block is None:
        block = tc.outer_comm.block
    rs = residual if residual is not None else [None] * len(delta)
    out = [compress_leaf(d, r, bits=bits, block=block) for d, r in zip(delta, rs)]
    return [p for p, _ in out], [r for _, r in out]


@torch.no_grad()
def outer_reduce_leaves(m_leaves, a_leaves, d_leaves, tc: TrainConfig, *, mu, lr,
                        inplace: bool = False):
    """Algorithm 2 lines 19-21 on explicit leaves.

    Returns ``(target_leaves_f32, new_momentum_leaves, new_anchor_leaves)``.
    Every leaf goes through the pier-update wrapper (``kernels/pier_update``):
    a CUDA leaf launches the fused kernel, a CPU leaf runs its plain
    version, the same function bit for bit. ``inplace`` (fp32 state only)
    writes the momentum and the target over the given momentum and anchor
    tensors; the target leaves are then the anchor leaves.
    """
    if not m_leaves:
        return [], [], []
    sdt = m_leaves[0].dtype
    if inplace and sdt != torch.float32:
        raise ValueError("in-place outer reduce needs fp32 outer state")
    p_new, m_new = [], []
    for m, a, d in zip(m_leaves, a_leaves, d_leaves):
        p, mm = kops.pier_update_leaf(a, m, d, tc, mu=mu, lr=lr,
                                      p_out=a if inplace else None,
                                      m_out=m if inplace else None)
        p_new.append(p)
        m_new.append(mm)
    anchor_new = p_new if inplace else [p.to(sdt) for p in p_new]
    return p_new, m_new, anchor_new


def outer_reduce(state: OuterState, delta_avg, tc: TrainConfig, *, mu, lr,
                 inplace: bool = False):
    """Algorithm 2, lines 19-21. Returns (target_leaves_f32, new_state).

    The new state's anchor IS the target (cast to the state dtype), so the
    next Δθ measures progress from the synchronized model. The
    error-feedback residuals pass through: the strategies'
    ``sim_dispatch`` makes the new ones, and with ``inplace`` writes them
    over the old ones, as the momentum and the anchor are.
    """
    p_new, m_new, anchor_new = outer_reduce_leaves(
        state.momentum, state.anchor, delta_avg, tc, mu=mu, lr=lr, inplace=inplace)
    return p_new, state._replace(momentum=m_new, anchor=anchor_new,
                                 num_syncs=state.num_syncs + 1)


@torch.no_grad()
def outer_apply(target_f32, dispatch_leaves, current_leaves):
    """Install a dispatched target with the stale-delta correction.

    ``θ ← target + (θ_t − θ_dispatch)`` per leaf in fp32, cast to the current
    leaf's dtype and written into ``current_leaves`` in place (returned).
    With ``dispatch_leaves`` the current leaves themselves (the eager path)
    the correction is exactly zero and the result equals the target.
    """
    for t, pd, pt in zip(target_f32, dispatch_leaves, current_leaves):
        drift = pt.float() - pd.float()
        pt.copy_(t + drift)
    return current_leaves


def outer_update(state: OuterState, delta_avg, tc: TrainConfig, *, mu, lr,
                 inplace: bool = False):
    """Eager fused update (sync_delay=0): :func:`outer_reduce` with zero
    in-flight drift. Returns (new_params_f32, new_state)."""
    return outer_reduce(state, delta_avg, tc, mu=mu, lr=lr, inplace=inplace)

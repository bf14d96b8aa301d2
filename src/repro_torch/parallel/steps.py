"""Step functions: the Pier training steps of one rank
(``repro/parallel/steps.py:build_train_steps``), the paged serve steps
(``build_paged_serve_steps``) and the dense serve steps
(``build_serve_steps``).

The reference jits each step over a device mesh whose manual axes are the
Pier groups; here each rank is one process of a
:class:`~repro_torch.launch.mesh.PierMesh` and holds one replica: its
group's parameters, AdamW state, and its own row of every error-feedback
residual (``(1, *leaf)``). The steps run eagerly and update in place:

- ``warmup_step``: the gradient mean over the whole world
  (``make_sgd_body(global_sync=True)``), then clip and AdamW;
- ``inner_step``: the gradient mean over the group's ``data_inner`` ranks
  only (nothing crosses groups);
- both return this rank's loss and pre-clip gradient norm as device
  tensors, without a host wait; :func:`mean_metrics` means a run of them
  over the world in one collective (the reference's ``pmean``, taken when
  the Trainer logs rather than in every step);
- ``accumulate_step``: the warmup momentum accumulation (a new, pending
  outer state; ``core.outer.warmup_reduce``);
- ``dispatch_step``: this group's Δθ (and the dispatch-time snapshot when
  the apply lands later), then the strategy's exchange started
  (``reduce_leaves``): a gloo collective with ``async_op=True``, or on the
  card the wire kernels enqueued on a dedicated stream behind an event;
- ``apply_step``: waits for the exchange, writes the new residuals, runs the
  outer update (``core.outer.outer_reduce``, the pier-update kernel on the
  card) and installs the target with the stale-delta correction. The outer
  update runs at apply rather than at dispatch: nothing reads the outer
  state inside the window, so the numbers are the same;
- ``outer_step``: dispatch and apply at once (``sync_delay == 0``);
- ``eval_step``: the loss, meaned over the world.

Elastic membership (the reference's ``elastic_*`` steps): ``dispatch_step``
and ``outer_step`` take the event's participation ``weights`` (the
strategy reduces with ``ReduceCtx.weights``, this group's own entry as
``ReduceCtx.weight``), and ``apply_step`` / ``outer_step`` a ``live`` flag:
an absent group's rank runs the outer update (the shared outer state moves
on) but leaves its parameters alone. ``bootstrap_group`` resets group
``g``'s rank to a donor (fresh AdamW state, zeroed residual rows) and
``init_residual`` gives a zero residual for a strategy switch.
``init_wire`` maps the wire's symmetric buffer; a bundle built mid-run (a
strategy switch) calls it on every rank at the same window.

The serve steps run without autograd on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core.outer import (OuterState, outer_apply, outer_init, outer_reduce,
                                    warmup_reduce)
from repro_torch.kernels.ring_allreduce import WireLayout
from repro_torch.kernels.symm import Exchange, SymmBuffer, align16
from repro_torch.kernels.wire import wire_shard_blocks
from repro_torch.launch.mesh import MeanWork, PierMesh, mean_
from repro_torch.models import registry as R
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import param_leaves
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import lr_at
from repro_torch.sync import Chunked, Hierarchical, Int8Wire, resolve_strategy
from repro_torch.sync.base import ReduceCtx
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KC
from repro_torch.serve import paged_model as PM


@dataclass
class PagedServeBundle:
    decode_step: Callable
    prefill_step: Callable
    init_pools: Callable
    device: torch.device


def build_paged_serve_steps(mc: ModelConfig, *, pcfg: KC.PagedCacheConfig,
                            device="cuda") -> PagedServeBundle:
    T.check_ported(mc)
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, pools, tokens, positions, block_tables, context_lens):
        return PM.paged_decode_step(params, mc, pools, tokens, positions,
                                    block_tables, context_lens, pcfg=pcfg)

    @torch.no_grad()
    def prefill_step(params, tokens, pools, block_table, last_index: int):
        logits, pools = PM.paged_prefill(params, mc, tokens, pools, block_table,
                                         pcfg=pcfg)
        # serving semantics: only the last real token's logits leave the
        # step (``last_index`` skips the block-padding tail)
        return logits[:, last_index], pools

    return PagedServeBundle(
        decode_step=decode_step, prefill_step=prefill_step,
        init_pools=lambda: KC.init_pools(mc, pcfg, dev), device=dev)


@dataclass
class ServeBundle:
    """The dense serve path's steps (``repro/parallel/steps.py:ServeBundle``
    without the mesh and shardings: one device)."""
    serve_step: Callable
    prefill_step: Callable
    init_state: Callable
    device: torch.device


def build_serve_steps(mc: ModelConfig, *, batch: int, max_len: int,
                      device="cuda") -> ServeBundle:
    """Dense serving of a static batch of ``batch`` sequences of up to
    ``max_len`` tokens: ``prefill_step(params, {"tokens": (B, S)})`` ->
    (logits (B, 1, V) of the last position, state), an encoder-decoder's
    batch with its ``"frames"`` (B, S_enc, d_model) too; ``serve_step(params,
    state, tokens (B, 1))`` -> (logits (B, 1, V), state); ``init_state()``."""
    T.check_ported(mc)
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, state, tokens):
        return R.decode_step(params, mc, state, tokens)

    @torch.no_grad()
    def prefill_step(params, batch_in):
        tokens = batch_in["tokens"]
        if tokens.shape[0] != batch:
            raise ValueError(f"prefill of {tokens.shape[0]} prompts in a bundle for {batch}")
        step_in = {"tokens": tokens}
        if mc.is_encoder_decoder:  # the encoder's input goes on to the prefill
            frames = batch_in.get("frames")
            if frames is None or frames.shape[0] != batch:
                raise ValueError(f"{mc.name}: the prefill needs frames for its {batch} "
                                 f"prompts")
            step_in["frames"] = frames
        # serving semantics: only the next-token logits leave the step
        return R.prefill(params, mc, step_in, max_len=max_len, last_only=True)

    return ServeBundle(
        serve_step=serve_step, prefill_step=prefill_step,
        init_state=lambda: R.init_decode_state(mc, batch, max_len, device=dev), device=dev)


# ===========================================================================
# Training
# ===========================================================================


class TrainState(NamedTuple):
    params: Any  # this rank's replica (training storage)
    opt: AdamWState


class DispatchState(NamedTuple):
    """An outer sync in flight: the started exchange, and what apply needs.

    ``snapshot`` is the replica at dispatch time: a copy when the apply
    lands later (the inner steps update the live parameters in place), the
    live leaves when it lands at once (zero drift). ``event`` marks the end
    of the exchange's work on its stream (CUDA), ``symm`` the buffer whose
    error flag apply reads.
    """

    pending: Any
    snapshot: List[torch.Tensor]
    mu: float
    lr: float
    event: Optional[Any] = None
    symm: Optional[SymmBuffer] = None


def mean_metrics(metrics: List[dict], world_size: int) -> List[dict]:
    """World means of the ``loss`` and ``grad_norm`` of several steps'
    metrics (collective: every rank passes as many), as floats. The mean is
    elementwise, so each step's value is the one a per-step mean gives."""
    keys = ("loss", "grad_norm")
    means = MeanWork([torch.stack([m[k].float() for m in metrics for k in keys])], None,
                     world_size).wait()[0].tolist() if metrics else []
    return [{**{k: float(v) for k, v in m.items() if k not in keys},
             **dict(zip(keys, means[len(keys) * i:len(keys) * (i + 1)]))}
            for i, m in enumerate(metrics)]


@dataclass
class StepBundle:
    mesh: PierMesh
    strategy: Any
    ctx: ReduceCtx
    init_state: Callable
    init_outer: Callable
    inner_step: Callable
    warmup_step: Callable
    accumulate_step: Callable
    dispatch_step: Callable
    apply_step: Callable
    eval_step: Callable
    close: Callable

    init_residual: Callable
    init_wire: Callable
    bootstrap_group: Callable

    def outer_step(self, state: TrainState, outer: OuterState, mu, olr, *, weights=None,
                   live: bool = True) -> OuterState:
        """Dispatch and apply at once (``sync_delay == 0``): the target
        installs on the live parameters, whose drift is zero."""
        return self.apply_step(state, outer,
                               self.dispatch_step(state, outer, mu, olr, snapshot=False,
                                                  weights=weights), live=live)


def _exchange(pg, ranks, rank) -> Exchange:
    return Exchange(group=pg, ranks=list(ranks), index=list(ranks).index(rank))


def _wire_capacity(strategy, shapes, E: int) -> int:
    """Bytes of the symmetric data region: E slots of the largest packed
    payload of one exchange stage (every leaf at once)."""
    inner = strategy.inner if isinstance(strategy, Hierarchical) else strategy
    bits, block = inner.bits, inner.block

    def nw(nq: int) -> int:
        return nq if bits >= 8 else (nq + 1) // 2

    sizes = []
    for shape in shapes:
        n = int(np.prod(shape)) if len(shape) else 1
        nb = -(-n // block)
        if inner.reduce_scatter:
            sb = wire_shard_blocks(nb, E)
            sizes.append((nw(sb * block), sb))
        else:
            sizes.append((nw(nb * block), nb))
    return E * align16(WireLayout(sizes).nbytes)


def build_train_steps(mc: ModelConfig, tc: TrainConfig, pc: ParallelConfig, mesh: PierMesh,
                      strategy=None, *, params=None) -> StepBundle:
    """The steps of this rank. ``params``: initial parameters in training
    storage (every rank must pass the same); by default made from
    ``tc.seed`` on the mesh's device, as ``SimulatedRun`` makes them."""
    T.check_token_batches(mc, "the Trainer", "synthetic pipeline's")
    strategy = strategy if strategy is not None else resolve_strategy(tc)
    if isinstance(strategy, Chunked):
        raise NotImplementedError(
            "Chunked is not ported to the multi-process Trainer yet (ROADMAP.md queue 1, "
            "\"Chunked in the Trainer\")")
    dev = mesh.device
    world_group_size = mesh.world_size
    nm = pc.num_microbatches

    # ---- the exchange of the outer sync ----------------------------------
    ex = _exchange(mesh.exchange, mesh.exchange_ranks, mesh.rank)
    fast = _exchange(mesh.fast, mesh.fast_ranks, mesh.rank)
    slow = _exchange(mesh.slow, mesh.slow_ranks, mesh.rank)
    hier = isinstance(strategy, Hierarchical)
    core = strategy.inner if hier else strategy
    ctx = ReduceCtx(exchange=ex, fast=fast if hier else None, slow=slow if hier else None)
    wire_ex = slow if hier else ex
    symm = None

    def init_state() -> TrainState:
        p = params if params is not None else R.init_params(mc, seed=tc.seed, device=dev,
                                                            training=True)
        p = p.to(dev)
        leaves = param_leaves(p)
        pdt = torch_dtype(mc.param_dtype)
        bad = [n for n, t in leaves if t.dtype != pdt or not t.requires_grad]
        if bad:
            raise ValueError(f"the Trainer needs parameters in training storage "
                             f"({mc.param_dtype}, requires_grad); not so: {bad[:3]}")
        return TrainState(params=p, opt=adamw_init(leaves, tc))

    def init_wire(state: TrainState) -> None:
        """Map the int8 wire's symmetric buffer (collective over the wire's
        exchange: every member calls it at the same point)."""
        nonlocal symm
        tensors = [t for _, t in param_leaves(state.params)]
        if (dev.type == "cuda" and isinstance(core, Int8Wire) and wire_ex.size > 1
                and symm is None):
            symm = SymmBuffer(wire_ex.group, wire_ex.size, wire_ex.index,
                              _wire_capacity(strategy, [t.shape for t in tensors], wire_ex.size),
                              dev)
            wire_ex.symm = symm

    def init_outer(state: TrainState) -> OuterState:
        tensors = [t for _, t in param_leaves(state.params)]
        plan = strategy.plan(tensors, tc)
        init_wire(state)
        return outer_init(tensors, tc, num_groups=1, needs_residual=plan.needs_residual,
                          needs_residual2=plan.needs_residual2)

    def init_residual(state: TrainState) -> List[torch.Tensor]:
        """A zero residual, this rank's (1, *leaf) row per leaf."""
        return [torch.zeros((1, *t.shape), dtype=torch.float32, device=t.device)
                for _, t in param_leaves(state.params)]

    # ---- the inner / warmup body -----------------------------------------
    def grads_and_loss(p, batch):
        leaves = param_leaves(p)
        if nm == 1:
            loss, _ = R.loss_fn(p, mc, batch)
            loss.backward()
            return [t.grad for _, t in leaves], loss.detach()
        B = batch["tokens"].shape[0]
        if B % nm:
            raise ValueError(f"rank batch {B} does not split into {nm} microbatches")
        per = B // nm
        lsum = None
        for i in range(nm):  # p.grad sums the microbatches in order
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, _ = R.loss_fn(p, mc, mb)
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        inv = torch.tensor(np.float32(1.0 / nm), device=dev)
        grads = [t.grad.mul_(inv) for _, t in leaves]
        return grads, lsum * inv

    def make_sgd_body(global_sync: bool):
        def body(state: TrainState, batch, step: int):
            leaves = param_leaves(state.params)
            grads, loss = grads_and_loss(state.params, batch)
            if global_sync:
                mean_(grads, None, world_group_size)
            else:
                mean_(grads, mesh.group, len(mesh.group_ranks))
            _, gnorm = clip_by_global_norm(grads, tc.clip_grad)
            lr = lr_at(tc, step)
            adamw_update(grads, state.opt, leaves, tc, lr)
            for _, t in leaves:
                t.grad = None
            return {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return body

    inner_step = make_sgd_body(global_sync=False)
    warmup_step = make_sgd_body(global_sync=True)

    def accumulate_step(state: TrainState, outer: OuterState, mu) -> OuterState:
        return warmup_reduce(outer, [t for _, t in param_leaves(state.params)], mu)

    # ---- outer events -----------------------------------------------------
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def member_ctx(weights) -> ReduceCtx:
        if weights is None:
            return ctx
        w = [float(x) for x in weights]  # in group order: the exchange's source order
        return ctx.with_membership(w, w[mesh.group_index])

    @torch.no_grad()
    def dispatch_step(state: TrainState, outer: OuterState, mu, olr, *,
                      snapshot: bool, weights=None) -> DispatchState:
        rctx = member_ctx(weights)
        cur = [t for _, t in param_leaves(state.params)]
        deltas = [p.float() - a.float() for p, a in zip(cur, outer.anchor)]
        snap = [t.detach().clone() for t in cur] if snapshot else cur
        res = None
        if outer.residual is not None:
            res = [r[0] for r in outer.residual]
            if outer.residual2 is not None:
                res = [(r1, r2[0]) for r1, r2 in zip(res, outer.residual2)]
        if side is None:
            pending = strategy.reduce_leaves(deltas, res, tc, rctx)
            return DispatchState(pending, snap, mu, olr)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            pending = strategy.reduce_leaves(deltas, res, tc, rctx)
            event = side.record_event()
        for d in deltas:  # made on the main stream, read on the side stream
            d.record_stream(side)
        for r in (outer.residual or []) + (outer.residual2 or []):
            r.record_stream(side)  # an offloaded state frees them before the side reads
        return DispatchState(pending, snap, mu, olr, event, symm)

    @torch.no_grad()
    def apply_step(state: TrainState, outer: OuterState, d: DispatchState, *,
                   live: bool = True) -> OuterState:
        """Finish the exchange, run the outer update and, on a ``live``
        group, install the target (an absent group's snapshot goes unused)."""
        if d.event is not None:
            torch.cuda.current_stream(dev).wait_event(d.event)
            if d.symm is not None:
                d.event.synchronize()  # the error flag is read after the kernels ran
                d.symm.check()
        payloads, new_res = d.pending.wait()
        if outer.residual is not None:
            pairs = new_res if outer.residual2 is not None else [(r, None) for r in new_res]
            for i, (r1, r2) in enumerate(pairs):
                outer.residual[i][0].copy_(r1)
                if r2 is not None:
                    outer.residual2[i][0].copy_(r2)
        targets, outer = outer_reduce(outer, payloads, tc, mu=d.mu, lr=d.lr,
                                      inplace=tc.opt_state_dtype == "float32")
        if live:
            outer_apply(targets, d.snapshot, [t for _, t in param_leaves(state.params)])
        return outer

    @torch.no_grad()
    def bootstrap_group(state: TrainState, outer: OuterState, g: int, donor) -> OuterState:
        """Rejoin bootstrap of group ``g``: on its ranks the parameters take
        the ``donor`` leaves, AdamW starts afresh (count 0, zero moments) and
        the residual rows are zeroed; other ranks are untouched."""
        if mesh.group_index != g:
            return outer
        for (_, p), dn in zip(param_leaves(state.params), donor):
            p.copy_(dn)
        state.opt.count.zero_()
        for m in state.opt.mu + state.opt.nu:
            m.zero_()
        for res in (outer.residual, outer.residual2):
            for r in res or ():
                r.zero_()
        return outer

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> float:
        loss, _ = R.loss_fn(state.params, mc, batch)
        return float(MeanWork([loss.detach()], None, world_group_size).wait()[0])

    def close():
        if symm is not None:
            symm.close()

    return StepBundle(mesh=mesh, strategy=strategy, ctx=ctx,
                      init_state=init_state, init_outer=init_outer,
                      inner_step=inner_step, warmup_step=warmup_step,
                      accumulate_step=accumulate_step, dispatch_step=dispatch_step,
                      apply_step=apply_step,
                      eval_step=eval_step, close=close, init_residual=init_residual,
                      init_wire=init_wire, bootstrap_group=bootstrap_group)

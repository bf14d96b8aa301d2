"""Single-process multi-group simulation of Pier / DiLoCo / AdamW.

Counterpart of ``repro/core/simulate.py:SimulatedRun``, the entry point of
the convergence experiments (paper Figs. 1, 3, 4; Tables III, IV). The
group structure is algorithmic: one model replica per group on one device.
It runs Algorithm 2 as the reference does: lazy start, momentum warmup,
G inner-AdamW groups on disjoint slices of each global batch, and the outer
Nesterov step with the μ-decay and outer-LR schedules, through the unified
outer-event stream (``core/pier.py``) with the same event order, including
``sync_delay > 0`` (the dispatched target installs ``sync_delay`` steps
later with the stale-delta correction).

What differs from the reference, and why:

- The groups are a Python loop over G parameter modules, not ``vmap``:
  the attention's CUDA autograd function does not batch.
- Training runs on ``device`` (the card unless the caller asks for the
  CPU). Parameters are kept in training storage (fp32 leaves cast at use).
  On CUDA leaves every outer sync launches the fused pier-update kernel
  and the attention runs the flash forward and backward kernels.
- State is updated in place, where JAX builds new arrays. Three places
  change meaning and are handled so:
  * the switch to groups hands the replica and its AdamW state to group 0
    and gives groups 1..G-1 clones, so no two groups share storage;
  * with ``sync_delay > 0`` the in-flight window keeps a clone of the
    dispatch-time group parameters (a reference would move with the inner
    steps, the drift would read 0 and the delayed path would silently
    become the eager one); with ``sync_delay == 0`` it keeps the live
    parameters, whose drift is exactly zero;
  * with fp32 outer state the new momentum and the target are written over
    the old momentum and the anchor (``core/outer.py``), saving one
    model-sized fp32 buffer.
  The compressed strategies' error-feedback residuals are written over
  the old ones in place too (``sync/base.py:sim_dispatch``); each group
  owns its row of a residual, and the lazy start's anchor advance leaves
  them as they are.
- Batches come from ``data/synthetic.py:MarkovLM`` through a
  ``torch.Generator`` (jax's threefry cannot be reproduced); the tables
  are the reference's. ``_global_batch`` is a method so that a caller can
  feed its own batches.

Every outer strategy of ``repro_torch.sync`` runs, from the config
(``OuterCommConfig``: quantize, int8-wire, rs-ag, hierarchical with
``num_pods``, chunks) or injected: on CUDA leaves every blockwise quantize
and dequantize launches its kernel. Not ported (they raise
``NotImplementedError``): ``Sharded``, sync controllers (and with them
``switch_strategy``), elastic membership and checkpoint managers.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.outer import (OuterState, outer_apply, outer_init,
                                    warmup_apply, warmup_reduce)
from repro_torch.core.pier import PierSchedule
from repro_torch.data.synthetic import MarkovLM, make_train_batch
from repro_torch.models import registry as R
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import param_leaves
from repro_torch.optim.adamw import adamw_init, adamw_update, clone_state
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import lr_at
from repro_torch.sync import PORTED, resolve_strategy, validate_pod_grouping


@dataclass
class SimState:
    params: Any  # single replica (warmup); group 0's after the switch
    group_params: Optional[List[Any]]  # G replicas, post-switch
    opt: Any  # AdamWState (single), or a list of G after the switch
    outer: OuterState
    step: int = 0


def _tensors(params) -> List[torch.Tensor]:
    return [p for _, p in param_leaves(params)]


class SimulatedRun:
    def __init__(self, mc: ModelConfig, tc: TrainConfig, *, num_groups: int,
                 seed: int = 0, num_pods: int = 1, strategy=None,
                 sync_controller=None, membership=None, checkpoint_manager=None,
                 device="cuda", params=None):
        """``params``: initial parameters in training storage (for example
        ``convert.params_from_jax(..., training=True)``); by default they
        are made from ``seed`` on ``device``."""
        if tc.optimizer != "adamw" and num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {num_groups}")
        validate_pod_grouping(num_groups, num_pods)
        for name, arg in (("sync_controller", sync_controller),
                          ("membership", membership),
                          ("checkpoint_manager", checkpoint_manager),
                          ("TrainConfig.membership", tc.membership)):
            if arg is not None:
                raise NotImplementedError(f"SimulatedRun: {name} is not ported yet")
        self.strategy = strategy if strategy is not None else resolve_strategy(tc)
        if not isinstance(self.strategy, PORTED):
            raise NotImplementedError(
                f"SimulatedRun: outer strategy {type(self.strategy).__name__} is not one "
                f"the port runs ({', '.join(c.__name__ for c in PORTED)}); Sharded is "
                f"ROADMAP.md queue 1, item 10")
        self.mc, self.tc = mc, tc
        self.G = num_groups
        self.P = max(num_pods, 1)
        self.device = resolve_device(device)
        self.sched = PierSchedule(tc)
        self.lm = MarkovLM(mc.vocab_size, seed=1234)
        if params is None:
            params = R.init_params(mc, seed=seed, device=self.device, training=True)
        else:
            params = params.to(self.device)
        leaves = param_leaves(params)
        pdt = torch_dtype(mc.param_dtype)
        bad = [n for n, p in leaves if p.dtype != pdt or not p.requires_grad]
        if bad:
            raise ValueError(f"SimulatedRun needs parameters in training storage "
                             f"({mc.param_dtype}, requires_grad); not so: {bad[:3]}")
        tensors = [p for _, p in leaves]
        # the plan's spans install per span at apply; it also says whether
        # the outer state carries error-feedback residuals
        self.plan = self.strategy.plan(tensors, tc)
        self.state = SimState(
            params=params, group_params=None, opt=adamw_init(leaves, tc),
            outer=outer_init(tensors, tc, num_groups=num_groups,
                             needs_residual=self.plan.needs_residual,
                             needs_residual2=self.plan.needs_residual2))
        # the new momentum and target overwrite the outer state in place
        # when it is fp32 (core/outer.py)
        self._inplace_outer = tc.opt_state_dtype == "float32"
        self._val_batch = None
        # the (single) in-flight window, uniform over ops:
        # (apply_at_step, "outer", target, snapshots) or
        # (apply_at_step, "accumulate", pending_outer, None)
        self._inflight = None

    # ------------------------------------------------------------ steps
    # Instance attributes, as the reference's jitted steps are, so that a
    # caller can wrap them (``chip_smoke.py`` times them).
    def _sgd_step(self, params, opt, batch, step: int) -> torch.Tensor:
        """One AdamW step on one replica, in place; returns the loss."""
        leaves = param_leaves(params)
        loss, _ = R.loss_fn(params, self.mc, batch)
        loss.backward()
        grads = [p.grad for _, p in leaves]
        clip_by_global_norm(grads, self.tc.clip_grad)
        adamw_update(grads, opt, leaves, self.tc, lr_at(self.tc, step))
        for _, p in leaves:
            p.grad = None  # free before the next replica's backward
        return loss.detach()

    def _warmup_step(self, batch, step: int) -> torch.Tensor:
        st = self.state
        return self._sgd_step(st.params, st.opt, batch, step)

    def _inner_step(self, batches, step: int) -> torch.Tensor:
        st = self.state
        losses = [self._sgd_step(gp, opt, b, step)
                  for gp, opt, b in zip(st.group_params, st.opt, batches)]
        return torch.stack(losses).mean()

    def _accumulate(self, mu):
        return warmup_reduce(self.state.outer, _tensors(self.state.params), mu)

    def _dispatch(self, mu, lr):
        st = self.state
        return self.strategy.sim_dispatch(
            [_tensors(g) for g in st.group_params], st.outer, self.tc, mu=mu, lr=lr,
            num_pods=self.P, inplace=self._inplace_outer)

    def _apply(self, target, snapshots):
        """Install the target on every group, span by span (a chunked plan's
        per-chunk applies; the correction is per leaf, so any span order
        gives the same numbers)."""
        for gp, snap in zip(self.state.group_params, snapshots):
            cur = _tensors(gp)
            for lo, hi in self.plan.spans:
                outer_apply(target[lo:hi], snap[lo:hi], cur[lo:hi])

    # ------------------------------------------------------------ batches
    def _global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed((self.tc.seed << 32) + step)
        return make_train_batch(self.lm, gen, self.tc.global_batch_size, self.tc.seq_len)

    def _group_batches(self, step: int) -> List[Dict[str, torch.Tensor]]:
        """G disjoint slices of the same global batch."""
        b = self._global_batch(step)
        per = self.tc.global_batch_size // self.G
        return [{k: v[g * per:(g + 1) * per] for k, v in b.items()} for g in range(self.G)]

    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _switch_to_groups(self):
        st = self.state
        st.group_params = [st.params] + [copy.deepcopy(st.params) for _ in range(self.G - 1)]
        st.opt = [st.opt] + [clone_state(st.opt) for _ in range(self.G - 1)]

    # ------------------------------------------------------------ the loop
    def run(self, num_steps: int, *, eval_every: int = 0) -> Dict[str, List]:
        """Run ``num_steps`` and return the loss history."""
        hist = {"step": [], "train_loss": [], "val_loss": [], "val_step": []}
        tc, st = self.tc, self.state
        for _ in range(num_steps):
            sched = self.sched
            step = st.step
            if sched.phase(step) == "warmup":
                loss = self._warmup_step(self._to_device(self._global_batch(step)), step)
                if (not sched.is_sync_step(step)
                        and (step + 1) % tc.sync_interval == 0):
                    # DiLoCo lazy start: advance the anchor without
                    # accumulating momentum
                    with torch.no_grad():
                        for a, p in zip(st.outer.anchor, _tensors(st.params)):
                            a.copy_(p)
            else:
                if st.group_params is None:
                    self._switch_to_groups()
                batches = [self._to_device(b) for b in self._group_batches(step)]
                loss = self._inner_step(batches, step)
            for ev in sched.events(step):
                if ev.kind == "apply":
                    if self._inflight is not None and self._inflight[0] <= step:
                        self._apply_inflight()
                    continue
                self._apply_inflight()  # the window is free by the schedule
                mu = sched.mu_at(step)
                if ev.op == "accumulate":
                    self._inflight = (ev.apply_step, "accumulate", self._accumulate(mu), None)
                else:
                    # the dispatch-time parameters: cloned when the apply
                    # lands later (in-place inner steps would move them),
                    # the live ones when it lands now (zero drift)
                    snapshots = [
                        [t.detach().clone() for t in _tensors(g)] if ev.apply_step > step
                        else _tensors(g) for g in st.group_params]
                    target, st.outer = self._dispatch(mu, sched.outer_lr_at(step))
                    self._inflight = (ev.apply_step, "outer", target, snapshots)
            if self._inflight is not None and self._inflight[0] <= step:
                self._apply_inflight()
            hist["step"].append(step)
            hist["train_loss"].append(float(loss))
            if eval_every and (step + 1) % eval_every == 0:
                p = st.group_params[0] if st.group_params is not None else st.params
                hist["val_loss"].append(self.val_loss(p))
                hist["val_step"].append(step)
            st.step += 1
        return hist

    def _apply_inflight(self):
        # A no-op when flush() already drained the window: the schedule's
        # apply event is step-based and does not know about early drains.
        if self._inflight is None:
            return
        st = self.state
        _, op, target, snapshots = self._inflight
        self._inflight = None
        if op == "accumulate":
            st.outer = warmup_apply(target)
            return
        self._apply(target, snapshots)
        st.params = st.group_params[0]

    def flush(self):
        """Apply an in-flight dispatch early (end-of-run drain)."""
        if self._inflight is not None:
            self._apply_inflight()

    @torch.no_grad()
    def val_loss(self, params) -> float:
        if self._val_batch is None:
            gen = torch.Generator().manual_seed(99991)
            self._val_batch = self._to_device(
                make_train_batch(self.lm, gen, 16, self.tc.seq_len))
        return float(R.loss_fn(params, self.mc, self._val_batch)[0])

    @torch.no_grad()
    def eval_params(self):
        """The groups' fp32 mean, as a new parameter module (or the single
        replica before the switch)."""
        st = self.state
        if st.group_params is None:
            return st.params
        out = copy.deepcopy(st.group_params[0])
        groups = [_tensors(g) for g in st.group_params]
        for i, t in enumerate(_tensors(out)):
            t.copy_(torch.stack([g[i].float() for g in groups]).mean(0))
        return out

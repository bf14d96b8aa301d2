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
  feed its own batches. They hold tokens and labels only, as the
  reference's do, so an encoder-decoder (Whisper, whose batches need
  ``"frames"``) is refused up front, where the reference fails on the
  missing key.

Every outer strategy of ``repro_torch.sync`` runs, from the config
(``OuterCommConfig``: quantize, int8-wire, rs-ag, hierarchical with
``num_pods``, chunks) or injected: on CUDA leaves every blockwise quantize
and dequantize launches its kernel. ``Sharded`` is not ported and raises
``NotImplementedError``.

As in the reference:

- an optional :class:`~repro_torch.sync.SyncController` is consulted after
  every outer dispatch (``tick_window``, then ``current_decision``): a
  strategy decision flushes the window and re-plans
  (:meth:`SimulatedRun.switch_strategy`), a delay decision rebuilds the
  schedule; the in-flight window keeps its stored ``apply_step``;
- elastic membership (a :class:`~repro_torch.sync.MembershipController`,
  or ``TrainConfig.membership`` for full membership through the same
  path) weighs each outer dispatch by its event's record, applies the
  target only on the live groups (an absent group's parameters, and its
  dispatch-time snapshot, are left alone; the shared outer state moves on)
  and bootstraps rejoining groups right after the apply, from the anchor
  or, with ``rejoin_bootstrap="checkpoint"``, the latest complete
  checkpoint of ``checkpoint_manager``: fresh AdamW state, zeroed residual
  rows. Membership with a chunked plan raises, as in the reference.
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
from repro_torch.models.transformer import check_token_batches, param_leaves
from repro_torch.optim.adamw import adamw_init, adamw_update, clone_state
from repro_torch.sync.membership import MembershipController
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import lr_at
from repro_torch.sync import PORTED, resolve_strategy, validate_pod_grouping


def _check_ported(strategy) -> None:
    if not isinstance(strategy, PORTED):
        raise NotImplementedError(
            f"SimulatedRun: outer strategy {type(strategy).__name__} is not one the port "
            f"runs ({', '.join(c.__name__ for c in PORTED)}); Sharded is ROADMAP.md queue "
            f"1, \"In-group TP/FSDP, Sharded and the memory dry run\"")


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
                 device="cuda", params=None, val_rows: int = 16):
        """``params``: initial parameters in training storage (for example
        ``convert.params_from_jax(..., training=True)``); by default they
        are made from ``seed`` on ``device``. ``membership``: a
        ``MembershipController`` over ``num_groups``; ``checkpoint_manager``:
        the donor of a ``rejoin_bootstrap="checkpoint"`` rejoin.
        ``val_rows``: the sequences of ``val_loss``'s fixed batch (the
        reference's 16; fewer where a model's validation forward would not
        fit beside its training state)."""
        if tc.optimizer != "adamw" and num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {num_groups}")
        validate_pod_grouping(num_groups, num_pods)
        check_token_batches(mc, "SimulatedRun", "MarkovLM")
        if not isinstance(tc.sync_delay, int):
            raise ValueError("sync_delay='auto' must be resolved before simulation "
                             "(launch/train.py:resolve_auto_sync_delay)")
        self.strategy = strategy if strategy is not None else resolve_strategy(tc)
        _check_ported(self.strategy)
        if membership is None and tc.membership is not None:
            membership = MembershipController(num_groups, cfg=tc.membership)
        if membership is not None and membership.num_groups != num_groups:
            raise ValueError(f"membership controller tracks {membership.num_groups} groups "
                             f"but the run has {num_groups}")
        self.sync_controller = sync_controller
        self.membership = membership
        self.ckpt = checkpoint_manager
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
        if membership is not None and self.plan.num_chunks > 1:
            raise NotImplementedError(
                "elastic membership does not compose with chunked dispatch yet (per-chunk "
                "weighted applies are a recorded follow-up): drop chunking or membership")
        self.state = SimState(
            params=params, group_params=None, opt=adamw_init(leaves, tc),
            outer=outer_init(tensors, tc, num_groups=num_groups,
                             needs_residual=self.plan.needs_residual,
                             needs_residual2=self.plan.needs_residual2))
        # the new momentum and target overwrite the outer state in place
        # when it is fp32 (core/outer.py)
        self._inplace_outer = tc.opt_state_dtype == "float32"
        self._val_rows = val_rows
        self._val_batch = None
        # the (single) in-flight window, uniform over ops:
        # (apply_at_step, "outer", target, snapshots) or
        # (apply_at_step, "accumulate", pending_outer, None)
        self._inflight = None
        # the EventMembership record of an in-flight outer dispatch (None
        # without membership): its apply's live mask and bootstraps
        self._inflight_member = None

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
        self.lr = lr_at(self.tc, step)
        adamw_update(grads, opt, leaves, self.tc, self.lr)
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

    def _dispatch(self, mu, lr, weights=None):
        st = self.state
        return self.strategy.sim_dispatch(
            [_tensors(g) for g in st.group_params], st.outer, self.tc, mu=mu, lr=lr,
            num_pods=self.P, weights=weights, inplace=self._inplace_outer)

    def _apply(self, target, snapshots, live=None):
        """Install the target on every group (on the ``live`` ones only,
        when a membership mask is given), span by span (a chunked plan's
        per-chunk applies; the correction is per leaf, so any span order
        gives the same numbers)."""
        for g, (gp, snap) in enumerate(zip(self.state.group_params, snapshots)):
            if live is not None and not live[g]:
                continue  # an absent group keeps its stale parameters
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
        """Run ``num_steps`` and return the history: each step's loss and
        the inner LR its AdamW steps took."""
        hist = {"step": [], "train_loss": [], "lr": [], "val_loss": [], "val_step": []}
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
                    rec = None
                    if self.membership is not None:
                        rec = self.membership.at(sched.outer_index(step))
                    target, st.outer = self._dispatch(
                        mu, sched.outer_lr_at(step), None if rec is None else rec.weights)
                    self._inflight = (ev.apply_step, "outer", target, snapshots)
                    self._inflight_member = rec
                    self._consult_controller()
            if self._inflight is not None and self._inflight[0] <= step:
                self._apply_inflight()
            hist["step"].append(step)
            hist["train_loss"].append(float(loss))
            hist["lr"].append(float(self.lr))
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
        rec, self._inflight_member = self._inflight_member, None
        self._inflight = None
        if op == "accumulate":
            st.outer = warmup_apply(target)
            return
        if rec is None:
            self._apply(target, snapshots)
            st.params = st.group_params[0]
            return
        # elastic apply: the live groups install the target, then the groups
        # rejoining at the next event bootstrap off the new anchor
        self._apply(target, snapshots, rec.apply_live)
        st.params = st.group_params[rec.apply_live.index(True)]
        for g in rec.bootstrap_after_apply:
            self._bootstrap_group(g)

    @torch.no_grad()
    def _bootstrap_group(self, g: int):
        """Rejoin bootstrap, right after an event's apply: group ``g``'s
        replica takes the donor's parameters (the freshly installed anchor,
        which is the applied target; or the latest complete checkpoint's
        ``params`` when ``rejoin_bootstrap="checkpoint"`` and a manager is
        attached), fresh AdamW state and zeroed residual rows."""
        st = self.state
        donor = None
        if (self.membership.cfg.rejoin_bootstrap == "checkpoint"
                and self.ckpt is not None):
            latest = self.ckpt.latest_step()
            if latest is not None:
                trees, _ = self.ckpt.restore(latest, {"params": st.group_params[g]})
                donor = list(trees["params"].values())
        if donor is None:
            donor = st.outer.anchor
        leaves = param_leaves(st.group_params[g])
        for (_, p), d in zip(leaves, donor):
            p.copy_(d)
        st.opt[g] = adamw_init(leaves, self.tc)
        for res in (st.outer.residual, st.outer.residual2):
            for r in res or ():
                r[g].zero_()

    # ------------------------------------------------------------ controllers
    def switch_strategy(self, strategy):
        """Adopt a new outer strategy mid-run: flush the in-flight window
        (it installs through the old plan), re-plan, and retarget the
        residuals: zeros of shape ``(G, *leaf)`` where the new plan needs
        them and the state lacks them (the first sync's semantics), dropped
        where it does not. Momentum, anchor and ``num_syncs`` carry over."""
        if strategy == self.strategy:
            return
        _check_ported(strategy)
        self.flush()
        self.strategy = strategy
        st = self.state
        tensors = _tensors(st.params)
        self.plan = strategy.plan(tensors, self.tc)

        def zeros():
            return [torch.zeros((self.G, *t.shape), dtype=torch.float32, device=t.device)
                    for t in tensors]

        outer = st.outer
        for field, need in (("residual", self.plan.needs_residual),
                            ("residual2", self.plan.needs_residual2)):
            have = getattr(outer, field) is not None
            if need and not have:
                outer = outer._replace(**{field: zeros()})
            elif have and not need:
                outer = outer._replace(**{field: None})
        st.outer = outer

    def _consult_controller(self):
        """One controller round after an outer dispatch (as the Trainer's):
        tick the window, then adopt the decision: the strategy first (it
        flushes the window just dispatched), then the clamped delay for the
        following windows, which rebuilds the schedule."""
        ctrl = self.sync_controller
        if ctrl is None:
            return
        ctrl.tick_window()
        dec = ctrl.current_decision()
        if dec.strategy is not None and dec.strategy != self.strategy:
            self.switch_strategy(dec.strategy)
        d = dec.clamped_delay(self.tc.sync_interval)
        if d != self.tc.sync_delay:
            self.tc = self.tc.replace(sync_delay=d)
            self.sched = PierSchedule(self.tc)

    def flush(self):
        """Apply an in-flight dispatch early (end-of-run drain)."""
        if self._inflight is not None:
            self._apply_inflight()

    @torch.no_grad()
    def val_loss(self, params) -> float:
        """The loss on a fixed batch of ``val_rows`` sequences (16 by
        default, as in the reference)."""
        if self._val_batch is None:
            gen = torch.Generator().manual_seed(99991)
            self._val_batch = self._to_device(
                make_train_batch(self.lm, gen, self._val_rows, self.tc.seq_len))
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

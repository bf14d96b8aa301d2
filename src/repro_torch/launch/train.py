"""Training launcher of the port: ``python -m repro_torch.launch.train ...``

Counterpart of ``repro/launch/train.py``: the multi-process Pier
:class:`Trainer` and ``main`` with the reference's flags. Each rank is one
process under ``torch.distributed``; a Pier group is ``data_inner`` ranks
(``launch/mesh.py``). The host loop consults :class:`PierSchedule` each
step: warmup (AdamW with the global gradient mean) -> momentum
accumulation every r steps -> group-local inner steps -> the outer
Nesterov sync every r steps. With ``sync_delay > 0`` every boundary is a
dispatch that starts the exchange and an apply ``sync_delay`` steps later,
through one in-flight window, as in the reference.

``main`` spawns ``--nproc`` ranks with ``torch.multiprocessing`` and a
``FileStore`` (or joins the ``torchrun`` world its environment names). On
the card, rank r takes ``cuda:(local_rank % device_count)``; ranks that
share a card exchange over gloo and over CUDA-IPC-mapped buffers
(``kernels/symm.py``). The parent builds the kernel library once before it
spawns, and the ranks only load it. Rank 0's history comes back to the
caller; the tests drive the same launcher (:func:`spawn`, :func:`train_job`).

As in the reference, the Trainer runs ``sync_delay="auto"`` (measured
t_comm / t_inner, or the adaptive strategy ladder), strategy switches,
elastic membership (``--churn-script``), outer-state offload (pinned host
memory, ``--offload``) and checkpoints (``--checkpoint-dir``,
``--ckpt-every``). Not ported (they raise ``NotImplementedError``):
Chunked and Sharded outer syncs, and ``--kernel-backend`` (the tensor's
device picks the kernel).
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

import numpy as np

from repro_torch import resolve_device
from repro_torch.config import (MembershipConfig, ModelConfig, OuterCommConfig, ParallelConfig,
                                TrainConfig)
from repro_torch.core import offload
from repro_torch.core.pier import PierSchedule
from repro_torch.kernels.symm import PEER_TIMEOUT_S
from repro_torch.launch.mesh import MeanWork
from repro_torch.models.transformer import param_leaves
from repro_torch.parallel.steps import build_train_steps, mean_metrics
from repro_torch.sync.delay import ModelDelayController

# Intra-op threads of a CPU rank. Ranks share the host with each other and
# with whatever else runs there; one thread each keeps an oversubscribed
# host from stalling every rank's parallel regions, and fixes the order
# in which CPU matmuls sum (which depends on the thread count).
CPU_THREADS = 1


def resolve_auto_sync_delay(tc: TrainConfig, mc: ModelConfig, pc: ParallelConfig, *,
                            chip: str = "", n_params: Optional[int] = None) -> int:
    """``sync_delay="auto"`` -> d* from the analytic step-time model
    (``sync/overlap_model.py``) and a ``chip`` hint; 0 (eager) when the
    model has no estimate (no chip, or one its table does not name, with a
    warning). The Trainer goes further and measures t_comm / t_inner; this
    is its fallback and the standalone entry point."""
    if tc.sync_delay != "auto":
        return tc.sync_delay
    return ModelDelayController(tc, mc, pc, chip=chip, n_params=n_params).initial_delay()


class Trainer:
    """Host-side training loop of one rank, weaving inner and outer steps
    per the schedule, with one in-flight dispatch/apply window.

    ``params``: initial parameters in training storage (every rank the
    same); by default made from ``tc.seed`` on the mesh's device.

    As the reference's Trainer: a sync controller (injected, or made by the
    strategy's hook when ``sync_delay="auto"``: measured, or with
    ``adaptive_sync`` walking the strategy ladder) is consulted after every
    outer dispatch, and a strategy switch flushes the window and moves to a
    step bundle cached per strategy (built on every rank at the same
    window); elastic membership (``membership``, or ``tc.membership``)
    weighs each outer dispatch, masks its apply and bootstraps rejoining
    groups; ``offload_outer_state`` keeps the outer state in pinned host
    memory between outer events; ``checkpoint_dir`` enables :meth:`save` /
    :meth:`restore`, one checkpoint of the whole world in the reference's
    layout (:meth:`save`).
    """

    def __init__(self, mc: ModelConfig, tc: TrainConfig, pc: ParallelConfig, mesh, *,
                 params=None, strategy=None, checkpoint_dir: Optional[str] = None,
                 chip_hint: str = "", sync_controller=None, adaptive_sync: bool = False,
                 remeasure_every: int = 0, membership=None):
        from repro_torch.sync import MembershipController, resolve_strategy

        if membership is not None:
            if membership.num_groups != pc.num_groups:
                raise ValueError(f"membership controller tracks {membership.num_groups} groups "
                                 f"but the layout has {pc.num_groups}")
            if tc.membership is None:
                tc = tc.replace(membership=membership.cfg)
        elif tc.membership is not None:
            membership = MembershipController(pc.num_groups, cfg=tc.membership)
        self.membership = membership
        self.mc, self.pc, self.mesh = mc, pc, mesh
        self.strategy = strategy if strategy is not None else resolve_strategy(tc)
        self.step = 0
        self.history: List[Dict[str, float]] = []
        # the (single) in-flight window: (apply_at, "outer", DispatchState)
        # or (apply_at, "accumulate", pending OuterState)
        self._inflight = None
        # the EventMembership record of an in-flight outer dispatch
        self._inflight_member = None
        # decisions taken, for the caller's report: (window, delay, strategy)
        self.decisions: List[tuple] = []
        # the controller's state after each window (controller_window())
        self.windows: List[Dict[str, Any]] = []
        self._windows = 0
        self._outer_on_host = False
        self.ckpt = None
        self._ckpt_pg = None  # the world over gloo (None: the default group is)
        if checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager

            self.ckpt = CheckpointManager(checkpoint_dir)
            if mesh.world_size > 1 and mesh.backend != "gloo":
                self._ckpt_pg = dist.new_group(backend="gloo")  # collective: every rank
        auto = tc.sync_delay == "auto"
        # the steps read no delay: build them first, so that the controller
        # can count the model's parameters
        self.tc = tc.replace(sync_delay=0) if auto else tc
        self._bundles = {}
        self._params0 = params
        self.state = None
        self.bundle = self._bundle_for(self.strategy)
        self.state = self.bundle.init_state()
        self.outer = self.bundle.init_outer(self.state)
        self.sync_controller = sync_controller
        if sync_controller is None and auto:
            n_params = sum(t.numel() for _, t in param_leaves(self.state.params))
            self.sync_controller = self.strategy.make_sync_controller(
                tc, mc, pc, chip=chip_hint, adaptive=adaptive_sync,
                remeasure_every=remeasure_every, n_params=n_params)
        if auto:
            dec = self.sync_controller.initial_decision()
            if dec.strategy is not None and dec.strategy != self.strategy:
                self._switch_strategy(dec.strategy)
            self.tc = tc.replace(sync_delay=dec.clamped_delay(tc.sync_interval))
        self.sched = PierSchedule(self.tc)
        self._outer_to_host()

    @property
    def delay_controller(self):
        """The scalar-delay half of the sync controller (None without one)."""
        c = self.sync_controller
        return c.delay_controller if c is not None else None

    def _bundle_for(self, strategy):
        b = self._bundles.get(strategy)
        if b is None:
            b = build_train_steps(self.mc, self.tc, self.pc, self.mesh, strategy,
                                  params=self._params0)
            self._bundles[strategy] = b
            if self.state is not None:
                b.init_wire(self.state)  # collective: every rank switches at this window
        return b

    # ------------------------------------------------------------ offload
    def _outer_to_device(self):
        if self._outer_on_host:
            self.outer = offload.to_device(self.outer, self.mesh.device)
            self._outer_on_host = False

    def _outer_to_host(self):
        if (self.tc.offload_outer_state and not self._outer_on_host
                and self.mesh.device.type == "cuda"):
            self.outer = offload.to_host(self.outer)
            self._outer_on_host = True

    def _sync(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def _measuring(self) -> bool:
        ctrl = self.sync_controller
        return ctrl is not None and ctrl.wants_measurement

    # ------------------------------------------------------------ the step
    def train_step(self, batch) -> Dict[str, Any]:
        """One scheduled step (inner or warmup) and its outer events.

        Returns this rank's metrics: ``loss`` and ``grad_norm`` as device
        tensors, not yet meaned over the world (:meth:`run` means them).
        While the controller measures, the step is timed between two
        ``torch.cuda.synchronize()`` calls (the kernels' time, not their
        enqueue) and an outer sync goes through dispatch and apply."""
        sched, step = self.sched, self.step
        measure = self._measuring()
        if measure:
            self._sync()
            t0 = time.perf_counter()
        if sched.phase(step) == "warmup":
            metrics = self.bundle.warmup_step(self.state, batch, step)
        else:
            metrics = self.bundle.inner_step(self.state, batch, step)
        if measure:
            self._sync()
            self.sync_controller.observe_step(time.perf_counter() - t0)
        events = sched.events(step)
        fused_outer = any(ev.kind == "dispatch" and ev.op == "outer" and ev.apply_step == step
                          for ev in events)
        if fused_outer and not measure:
            self._apply_inflight()
            self._outer_to_device()
            kw, rec = {}, None
            if self.membership is not None:
                rec = self.membership.at(sched.outer_index(step))
                kw = {"weights": rec.weights, "live": rec.apply_live[self.mesh.group_index]}
            self.outer = self.bundle.outer_step(self.state, self.outer, sched.mu_at(step),
                                                sched.outer_lr_at(step), **kw)
            if rec is not None:
                self._bootstrap_groups(rec.bootstrap_after_apply)
            self._outer_to_host()
            self._consult_controller()
        else:
            for ev in events:
                if ev.kind == "apply":
                    # the stored apply_step is authoritative: a delay adopted
                    # mid-window must not cut the dispatched window short
                    if self._inflight is not None and self._inflight[0] <= step:
                        self._apply_inflight()
                    continue
                self._apply_inflight()  # the window is free by the schedule
                if ev.op == "accumulate":
                    self._dispatch_accumulate(ev)
                else:
                    self._inflight = (ev.apply_step, "outer", self._dispatch(step))
                    self._consult_controller()
            if self._inflight is not None and self._inflight[0] <= step:
                self._apply_inflight()
        self.step += 1
        return metrics

    def _dispatch_accumulate(self, ev):
        """Warmup accumulate: eager (``apply_step == sync_step``) installs
        the new outer state at once; delayed, the pending state installs
        at its apply (the correction is identically zero). While the
        controller measures, the window is timed as a warmup window and a
        freshly resolved delay is adopted. The reference's accumulate means
        the parameters over the world (``_global_pmean``), and that
        exchange is what its warmup windows time. The port's warmup
        replicas are the same on every rank, so its accumulate needs no
        exchange; a measured window runs the same exchange
        (:meth:`_warmup_exchange`) and drops its result, so that the sample
        is one of an fp32 world exchange while every value stays local."""
        measure = self._measuring()
        if measure:
            self._sync()
            t0 = time.perf_counter()
            self._warmup_exchange()
        self._outer_to_device()
        pending = self.bundle.accumulate_step(self.state, self.outer,
                                              self.sched.mu_at(ev.sync_step))
        if ev.apply_step <= ev.sync_step:
            self.outer = pending
        else:
            self._inflight = (ev.apply_step, "accumulate", pending)
        if measure:
            self._sync()
            self.sync_controller.observe_window(t_comm=time.perf_counter() - t0, warmup=True)
            self._adopt_delay(self.sync_controller.current_decision())
        self._outer_to_host()

    def _warmup_exchange(self):
        """A world fp32 mean of the parameters, as the reference's warmup
        accumulate makes; the means are dropped."""
        MeanWork([t.detach() for _, t in param_leaves(self.state.params)], None,
                 self.mesh.world_size).wait()

    def _dispatch(self, step: int):
        """Start the outer exchange of the boundary at ``step``; the
        dispatch-time parameters are copied when the apply lands later.
        While the controller measures, the host waits for the exchange to
        finish and passes the dispatch-to-ready time on."""
        sched = self.sched
        measure = self._measuring()
        if measure:
            self._sync()
            t0 = time.perf_counter()
        self._outer_to_device()
        kw = {}
        if self.membership is not None:
            rec = self.membership.at(sched.outer_index(step))
            self._inflight_member = rec
            kw["weights"] = rec.weights
        d = self.bundle.dispatch_step(self.state, self.outer, sched.mu_at(step),
                                      sched.outer_lr_at(step),
                                      snapshot=sched.apply_step_for(step) > step, **kw)
        self._outer_to_host()
        if measure:
            d.pending.wait()
            if d.event is not None:
                d.event.synchronize()
            self.sync_controller.observe_window(t_comm=time.perf_counter() - t0)
        return d

    def _apply_inflight(self):
        # a no-op when flush() already drained the window
        if self._inflight is None:
            return
        _, op, payload = self._inflight
        rec, self._inflight_member = self._inflight_member, None
        self._inflight = None
        self._outer_to_device()
        if op == "accumulate":
            self.outer = payload
        elif rec is None:
            self.outer = self.bundle.apply_step(self.state, self.outer, payload)
        else:
            self.outer = self.bundle.apply_step(self.state, self.outer, payload,
                                                live=rec.apply_live[self.mesh.group_index])
            self._bootstrap_groups(rec.bootstrap_after_apply)
        self._outer_to_host()

    # ------------------------------------------------------------ controllers
    def _consult_controller(self):
        """One decision round after an outer window: tick, then the strategy
        (it flushes the window just dispatched), then the clamped delay."""
        ctrl = self.sync_controller
        if ctrl is None:
            return
        ctrl.tick_window()
        self._windows += 1
        dec = ctrl.current_decision()
        if dec.strategy is not None and dec.strategy != self.strategy:
            self._switch_strategy(dec.strategy)
        self._adopt_delay(dec)
        self.windows.append(self.controller_window())

    def controller_window(self) -> Dict[str, Any]:
        """What the sync controller holds now (for the report)."""
        ctrl, dc = self.sync_controller, self.delay_controller
        return {"window": self._windows, "step": self.step,
                "t_inner_s": getattr(dc, "t_inner", None),
                "t_comm_s": getattr(dc, "t_comm", None),
                "measured_windows": getattr(dc, "windows", None),
                "wants_measurement": bool(ctrl.wants_measurement),
                "sync_delay": self.tc.sync_delay, "rung": getattr(ctrl, "rung", None),
                "strategy": self.strategy.name}

    def _adopt_delay(self, dec):
        """Adopt a decision's clamped delay (rebuilding the schedule)."""
        d = dec.clamped_delay(self.tc.sync_interval)
        if d != self.tc.sync_delay:
            if self.mesh.rank == 0:
                print(f"sync_delay re-resolved: {self.tc.sync_delay} -> {d} "
                      f"({type(self.sync_controller).__name__} decision)", flush=True)
            self.decisions.append((self._windows, d, None))
            self.tc = self.tc.replace(sync_delay=d)
            self.sched = PierSchedule(self.tc)

    def _switch_strategy(self, strategy):
        """Adopt a new outer strategy mid-run: flush the in-flight window
        through the old bundle, move to the new strategy's cached bundle
        (built, and its wire buffer mapped, on every rank now), and retarget
        the residuals: zero rows where the new plan needs them and the state
        lacks them, dropped where it does not. The old bundle is kept (and
        closed by :meth:`close`)."""
        self.flush()
        if self.mesh.rank == 0:
            print(f"outer-sync strategy switch: {self.strategy.name} -> {strategy.name}",
                  flush=True)
        self.decisions.append((self._windows, None, strategy.name))
        self.strategy = strategy
        self.bundle = self._bundle_for(strategy)
        self._outer_to_device()
        plan = strategy.plan([t for _, t in param_leaves(self.state.params)], self.tc)
        outer = self.outer
        for field, need in (("residual", plan.needs_residual),
                            ("residual2", plan.needs_residual2)):
            have = getattr(outer, field) is not None
            if need and not have:
                outer = outer._replace(**{field: self.bundle.init_residual(self.state)})
            elif have and not need:
                outer = outer._replace(**{field: None})
        self.outer = outer
        self._outer_to_host()

    # ------------------------------------------------------------ membership
    def _bootstrap_groups(self, groups):
        """Rejoin bootstrap right after an event's apply: each named group's
        ranks take the donor's parameters (the freshly installed anchor, or
        the latest checkpoint's with ``rejoin_bootstrap="checkpoint"``),
        fresh AdamW state and zeroed residual rows."""
        if self.mesh.group_index not in groups:  # bootstrap_group leaves other ranks alone
            return
        self._outer_to_device()
        donor = self._bootstrap_donor()
        for g in groups:
            self.outer = self.bundle.bootstrap_group(self.state, self.outer, g, donor)

    def _bootstrap_donor(self):
        cfg = self.tc.membership
        if cfg is not None and cfg.rejoin_bootstrap == "checkpoint" and self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                with self.ckpt.reader(latest, "outer") as rd:
                    return [rd.tensor("anchor/" + n, a)
                            for n, a in zip(self._names(), self.outer.anchor)]
        return self.outer.anchor

    # ------------------------------------------------------------ checkpoints
    def _names(self):
        return [n.replace(".", "/") for n, _ in param_leaves(self.state.params)]

    def _ckpt_leaves(self):
        """``[(tree, key, tensor, stacked)]`` of this rank's share of a
        checkpoint, in the order the archive holds them, under the
        reference's keys: its ``TrainState`` in ``state`` (every leaf
        (G,)-stacked, a row a group) and its ``OuterState`` in ``outer``
        (momentum and anchor whole, the same on every rank; the residual
        rows (G,)-stacked; ``num_syncs`` apart, a number)."""
        names, st, o = self._names(), self.state, self.outer
        params = [t for _, t in param_leaves(st.params)]
        out = [("state", "opt/count", st.opt.count, True)]
        for field, leaves in (("params", params), ("opt/mu", st.opt.mu), ("opt/nu", st.opt.nu)):
            out += [("state", f"{field}/{n}", t, True) for n, t in zip(names, leaves)]
        for field, leaves in (("momentum", o.momentum), ("anchor", o.anchor)):
            out += [("outer", f"{field}/{n}", t, False) for n, t in zip(names, leaves)]
        for field in ("residual", "residual2"):
            rows = getattr(o, field)
            if rows is not None:
                out += [("outer", f"{field}/{n}", r[0], True) for n, r in zip(names, rows)]
        order = {"state": 0, "outer": 1}
        return sorted(out, key=lambda e: (order[e[0]], e[1]))

    def _group_ranks0(self) -> List[int]:
        """Each group's first rank (data_inner index 0), in group order."""
        return list(range(0, self.mesh.world_size, self.pc.data_inner))

    def save(self):
        """Checkpoint the world at the current step, in the reference's
        layout (``src/repro/launch/train.py:save``): one ``step_*`` directory
        holding the (G,)-stacked ``TrainState`` (``state.npz``), the
        ``OuterState`` (``outer.npz``) and the port's own state (the outer
        strategy, ``trainer.npz``), the manifest last with the reference's
        metadata. Collective. Rank 0 writes every leaf a row at a time,
        receiving each other group's row over gloo from that group's first
        rank, so no rank holds more than one leaf's row on the host. The
        window is flushed first: a checkpoint never strands an in-flight
        dispatch."""
        from repro_torch.checkpoint import Rows

        if self.ckpt is None:
            raise ValueError("Trainer.save needs checkpoint_dir")
        self.flush()
        leaves, firsts, pg = self._ckpt_leaves(), self._group_ranks0(), self._ckpt_pg
        if self.mesh.rank == 0:
            def rows(t):
                yield t
                for src in firsts[1:]:
                    buf = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8)
                    dist.recv(buf, src=src, group=pg)
                    yield buf.view(t.dtype).view(t.shape)

            trees = {"state": {}, "outer": {"num_syncs": np.int32(self.outer.num_syncs)},
                     "trainer": {"strategy": self.strategy.name}}
            for tree, key, t, stacked in leaves:
                trees[tree][key] = Rows(len(firsts), t.shape, t.dtype, rows(t)) if stacked else t
            self.ckpt.save(self.step, trees,
                           metadata={"step": self.step, "optimizer": self.tc.optimizer})
        elif self.mesh.rank in firsts:
            for _, _, t, stacked in leaves:
                if stacked:
                    dist.send(t.detach().reshape(-1).cpu().view(torch.uint8), dst=0, group=pg)
        if self.mesh.world_size > 1:
            dist.barrier(group=pg)

    def restore(self, step: Optional[int] = None):
        """Load a checkpoint into this rank (collective): rank 0 picks the
        newest complete step (or checks ``step``), and each rank reads its
        group's row of every stacked leaf, a leaf at a time, without the
        other rows. Reads the reference Trainer's checkpoints too."""
        if self.ckpt is None:
            raise ValueError("Trainer.restore needs checkpoint_dir")
        err = None
        if self.mesh.rank == 0:
            steps = self.ckpt.all_steps()  # the CRC sweep, on rank 0 only
            if step is None and not steps:
                err = f"no complete checkpoint under {self.ckpt.directory}"
            elif step is None:
                step = steps[-1]
            elif step not in steps:
                err = f"checkpoint step_{step:08d} under {self.ckpt.directory} is not complete"
        if self.mesh.world_size > 1:
            box = [step, err]
            dist.broadcast_object_list(box, src=0, group=self._ckpt_pg)
            step, err = box
        if err is not None:
            raise ValueError(err)
        manifest = self.ckpt.manifest(step)
        g = self.mesh.group_index
        self._outer_to_device()
        leaves = self._ckpt_leaves()
        with torch.no_grad():
            for tree in ("state", "outer"):
                with self.ckpt.reader(step, tree, check=False) as rd:
                    for _, key, t, stacked in (e for e in leaves if e[0] == tree):
                        t.copy_(rd.tensor(key, t, g if stacked else None, where=f"{tree}/{key}"))
                    if tree == "outer":
                        num_syncs = int(rd.read("num_syncs"))
        if "trainer" in manifest["trees"]:
            with self.ckpt.reader(step, "trainer", check=False) as rd:
                saved = str(rd.read("strategy"))
            if saved != self.strategy.name:
                raise ValueError(f"checkpoint step_{step:08d} was saved under the outer "
                                 f"strategy {saved}, this Trainer runs {self.strategy.name}")
        self.outer = self.outer._replace(num_syncs=num_syncs)
        self.step = int(manifest["metadata"]["step"])
        self._inflight = None  # checkpoints are saved flushed
        self._inflight_member = None
        self._outer_to_host()

    # ------------------------------------------------------------ running
    def flush(self):
        """Drain an in-flight dispatch (end of run, before a checkpoint)."""
        if self._inflight is not None:
            self._apply_inflight()

    def run(self, steps: int, pipeline, *, log_every: int = 10, ckpt_every: int = 0):
        """Run ``steps`` steps; the history holds each step's world-mean
        loss and gradient norm, meaned in one collective at every log step
        and at the end (the inner steps themselves wait for no other group).
        ``ckpt_every``: save every that many steps (needs a checkpoint
        directory)."""
        t0 = time.time()
        local = []
        for _ in range(steps):
            local.append(self.train_step(next(pipeline)))
            if log_every and self.step % log_every == 0:
                self.history += mean_metrics(local, self.mesh.world_size)
                local = []
                if self.mesh.rank == 0:
                    metrics = self.history[-1]
                    dt = (time.time() - t0) / max(self.step, 1)
                    print(f"step {self.step:6d} loss {metrics['loss']:.4f} "
                          f"lr {metrics['lr']:.2e} gnorm {metrics['grad_norm']:.3f} "
                          f"({dt * 1e3:.0f} ms/step avg)", flush=True)
            if ckpt_every and self.ckpt is not None and self.step % ckpt_every == 0:
                self.save()
        self.history += mean_metrics(local, self.mesh.world_size)
        self.flush()
        return self.history

    def eval_loss(self, batch) -> float:
        """The loss of this rank's replica on ``batch``, meaned over the world."""
        return self.bundle.eval_step(self.state, batch)

    def close(self):
        """Free every bundle's symmetric buffers (collective)."""
        for b in self._bundles.values():
            b.close()


# ---------------------------------------------------------------------------
# spawning a world
# ---------------------------------------------------------------------------


@dataclass
class RankInfo:
    rank: int
    world: int
    device: torch.device


def _init_rank(rank: int, world: int, device_type: str, init_method: str) -> RankInfo:
    from repro_torch.launch.mesh import backend_for

    if device_type == "cuda":
        n = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % n)
        torch.cuda.set_device(device)
        backend = backend_for(device, world, n)
    else:
        device = torch.device("cpu")
        backend = "gloo"
        torch.set_num_threads(CPU_THREADS)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PEER_TIMEOUT_S))
    return RankInfo(rank, world, device)


def _rank_entry(fn, args, kwargs, rank, world, device_type, workdir):
    try:
        info = _init_rank(rank, world, device_type,
                          "file://" + os.path.join(workdir, "store"))
        out = fn(info, *args, **kwargs)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, args=(), kwargs=None, *, nproc: int, device: str = "cuda",
          timeout: Optional[float] = None, workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(RankInfo, *args, **kwargs)`` on ``nproc`` new processes and
    return their results in rank order.

    ``fn`` must be importable by name (a module-level function). Ranks meet
    through a ``FileStore`` in a fresh directory (under ``workdir`` if
    given), so no port is taken. On ``cuda`` the parent builds the kernel
    library first. If a rank fails, or ``timeout`` seconds pass, every rank
    is killed and the call raises with the failing rank's traceback.
    """
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # once, here: the ranks only load it
    work = tempfile.mkdtemp(prefix="pier_world_", dir=workdir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, tuple(args), dict(kwargs or {}), r, nproc, dev.type, work))
             for r in range(nproc)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawned world of {nproc} ranks passed its deadline of "
                                   f"{timeout} s")
            time.sleep(0.02)
        if failed is not None:
            errs = [os.path.join(work, f"rank{r}.err") for r in range(nproc)]
            msg = "".join(f"--- rank {r} ---\n{open(e).read()}"
                          for r, e in enumerate(errs) if os.path.exists(e))
            raise RuntimeError(f"rank {failed} failed (exit code {procs[failed].exitcode}):\n"
                               f"{msg}")
        out = []
        for r in range(nproc):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# one training run on every rank
# ---------------------------------------------------------------------------


def _launch_counts():
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import pier_update as PK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import ring_allreduce as RA
    from repro_torch.kernels import rmsnorm as RK

    return {"flash_attention": (FK, "launches"), "flash_attention_bwd": (FK, "bwd_launches"),
            "flash_attention_tc": (FK, "tc_launches"),
            "flash_attention_bwd_tc": (FK, "tc_bwd_launches"),
            "quantize_blockwise": (QK, "launches"),
            "dequantize_blockwise": (QK, "dequantize_launches"),
            "pier_update": (PK, "launches"), "ring_allgather": (RA, "ring_launches"),
            "shard_scatter": (RA, "scatter_launches"), "rmsnorm": (RK, "launches"),
            "rmsnorm_bwd": (RK, "bwd_launches")}


def train_job(info: RankInfo, mc: ModelConfig, tc: TrainConfig, pc: ParallelConfig,
              steps: int, *, params=None, batches=None, keep_params: bool = False,
              val_batch=None, timed: bool = False, log_every: int = 0, churn: str = "",
              sync_controller=None, chip_hint: str = "", adaptive_sync: bool = False,
              remeasure_every: int = 0, checkpoint_dir: Optional[str] = None,
              restore: bool = False, save: bool = False,
              ckpt_every: int = 0) -> Dict[str, Any]:
    """Build the mesh and a :class:`Trainer` on this rank and run ``steps``.

    ``params``: a state dict of initial parameters (CPU tensors), made
    from ``tc.seed`` when absent. ``batches``: global batches (dicts of
    CPU tensors) to feed instead of the synthetic pipeline's. ``val_batch``:
    a batch whose world-mean loss is taken before and after the run.
    ``timed``: host times of each step kind (after a synchronize), of one
    step's world metric mean (``metric_mean``, five calls after the run).
    On the card: peak device memory, and the memory allocated after the run
    (``resident_bytes``). ``churn``: a ``--churn-script`` spec (with
    ``tc.membership``); ``sync_controller`` / ``chip_hint`` /
    ``adaptive_sync`` / ``remeasure_every`` as the Trainer takes them (the
    controller's state after every window is reported). With
    ``checkpoint_dir``: ``restore`` loads the newest complete checkpoint
    first (the run then goes on from its step), ``save`` checkpoints at the
    end, ``ckpt_every`` saves along the way. Returns this rank's history,
    launch counts and, with ``keep_params``, its final parameters and
    residuals on the CPU.
    """
    from repro_torch.sync import ChurnSchedule, MembershipController
    from repro_torch.data.pipeline import DataPipeline, synthetic_pipeline
    from repro_torch.launch.mesh import make_pier_mesh
    from repro_torch.models import registry as R

    mesh = make_pier_mesh(pc, device=info.device)
    p0 = None
    if params is not None:
        p0 = R.init_params(mc, seed=0, device="cpu", training=True)
        p0.load_state_dict(params)
    cuda = info.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(info.device)
    membership = None
    if churn:
        membership = MembershipController(pc.num_groups, cfg=tc.membership or MembershipConfig(),
                                          schedule=ChurnSchedule.parse(churn))
    t_init = time.perf_counter()
    trainer = Trainer(mc, tc, pc, mesh, params=p0, membership=membership,
                      sync_controller=sync_controller, chip_hint=chip_hint,
                      adaptive_sync=adaptive_sync, remeasure_every=remeasure_every,
                      checkpoint_dir=checkpoint_dir)
    t_init = time.perf_counter() - t_init
    ckpt_s = {}
    if restore:
        t0 = time.perf_counter()
        trainer.restore()
        ckpt_s["restore_s"] = time.perf_counter() - t0
    times: Dict[str, List[float]] = {}
    if timed:
        def wrap(name, fn):
            def call(*a, **k):
                if cuda:
                    torch.cuda.synchronize(info.device)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if cuda:
                    torch.cuda.synchronize(info.device)
                times.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        b = trainer.bundle
        for name in ("warmup_step", "inner_step", "accumulate_step", "dispatch_step",
                     "apply_step"):
            setattr(b, name, wrap(name, getattr(b, name)))
    val = {}
    if val_batch is not None:
        vb = {k: v.to(info.device) for k, v in val_batch.items()}
        val["val_loss_before"] = trainer.eval_loss(vb)
    start = trainer.step
    if batches is None:
        pipe = synthetic_pipeline(mc, tc, rank=mesh.rank, world=mesh.world_size,
                                  device=info.device, start=start, stop=start + steps)
    else:
        pipe = DataPipeline(lambda s: batches[s], rank=mesh.rank, world=mesh.world_size,
                            device=info.device, start=start, stop=start + steps)
    counts = _launch_counts()
    for mod, attr in counts.values():
        setattr(mod, attr, 0)
    from repro_torch.kernels import ring_allreduce as RA

    RA.event_log = [] if timed and cuda else None
    try:
        t0 = time.perf_counter()
        hist = trainer.run(steps, pipe, log_every=log_every, ckpt_every=ckpt_every)
        if cuda:
            torch.cuda.synchronize(info.device)
        wall = time.perf_counter() - t0
    finally:
        pipe.close()
    if cuda:  # what stays on the card between outer events
        ckpt_s["resident_bytes"] = torch.cuda.memory_allocated(info.device)
    if save:
        t0 = time.perf_counter()
        trainer.save()
        ckpt_s["save_s"] = time.perf_counter() - t0
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counts.items()}
    if timed:  # one step's world mean of its metrics, as a per-step mean would cost
        one = torch.zeros((), device=info.device)
        for _ in range(5):
            wrap("metric_mean", lambda: mean_metrics([{"loss": one, "grad_norm": one}],
                                                     mesh.world_size))()
    if RA.event_log is not None:
        for name, start, end in RA.event_log:
            times.setdefault(name + "_device", []).append(start.elapsed_time(end))
        RA.event_log = None
    if val_batch is not None:
        val["val_loss_after"] = trainer.eval_loss(vb)
    out = {"rank": mesh.rank, "group": mesh.group_index, "history": hist,
           "launches": launches, "wall_s": wall, "init_s": t_init, "times_ms": times,
           "strategy": trainer.strategy.name, "backend": mesh.backend,
           "leaves": len(param_leaves(trainer.state.params)),
           "device": str(info.device), "final_step": trainer.step,
           "sync_delay": trainer.tc.sync_delay, "decisions": trainer.decisions,
           "windows": trainer.windows,
           "controller": (None if trainer.sync_controller is None
                          else trainer.controller_window()),
           **ckpt_s, **val}
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(info.device)
    if keep_params:
        out["params"] = [t.detach().cpu().clone() for _, t in param_leaves(trainer.state.params)]
        out["param_names"] = [n for n, _ in param_leaves(trainer.state.params)]
        o = trainer.outer
        out["residual"] = None if o.residual is None else [r[0].cpu() for r in o.residual]
        out["residual2"] = None if o.residual2 is None else [r[0].cpu() for r in o.residual2]
        out["num_syncs"] = o.num_syncs
    trainer.close()
    del trainer
    if cuda:  # the next job in this world starts from a free card
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_jobs(info: RankInfo, jobs) -> List[Dict[str, Any]]:
    """Several :func:`train_job` runs, one after another, in one world:
    ``jobs`` is a list of ``(args, kwargs)``. Spawning once saves each
    run the ranks' start-up. Between runs a finished run's memory is
    given back (its trainer holds reference cycles, which only the
    collector frees; ranks that share a card cannot use each other's
    cached blocks)."""
    out = []
    for a, k in jobs:
        out.append(train_job(info, *a, **k))
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Pier training launcher (PyTorch port)")
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true", help="use the reduced smoke-scale config")
    ap.add_argument("--optimizer", default="pier", choices=["pier", "diloco", "adamw"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="schedule horizon (defaults to --steps)")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--sync-interval", type=int, default=10)
    ap.add_argument("--sync-delay", default="0",
                    help="overlap the outer exchange with this many inner steps (0 = eager; "
                         "'auto' = measured d*, the --chip model until then)")
    ap.add_argument("--chip", default="",
                    help="chip hint of the step-time model for --sync-delay auto (one of "
                         "the reference's table; others fall back to eager)")
    ap.add_argument("--adaptive-sync", action="store_true",
                    help="with --sync-delay auto: also step down the strategy ladder when "
                         "the measured t_comm stays exposed at the largest legal delay")
    ap.add_argument("--remeasure-every", type=int, default=0,
                    help="re-measure t_comm / t_inner every N sync windows (0 = once)")
    ap.add_argument("--outer-compression", default="none",
                    choices=["none", "quantize", "int8-wire", "rs-ag"])
    ap.add_argument("--outer-comm-bits", type=int, default=8, choices=[4, 8])
    ap.add_argument("--hierarchical-reduce", action="store_true",
                    help="two-stage outer reduce: fp32 in the pod, the strategy across pods")
    ap.add_argument("--groups", type=int, default=2, help="Pier groups (data_outer)")
    ap.add_argument("--mesh", default="",
                    help="layout data_outer,data_inner,model (model must be 1), or "
                         "pods,data_outer,data_inner,model; default: --groups groups of one "
                         "rank")
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: join the torchrun world of the "
                         "environment, or spawn the layout's rank count)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--churn-script", default="",
                    help="scripted elastic membership keyed on the post-warmup outer event, "
                         "e.g. 'drop:1@3,rejoin:1@6,straggle:0@4+2'")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="a group more than this many missed outer events behind is evicted")
    ap.add_argument("--min-live", type=int, default=1,
                    help="refuse a churn script that leaves fewer contributing groups")
    ap.add_argument("--rejoin-bootstrap", default="anchor", choices=["anchor", "checkpoint"],
                    help="a rejoining group's donor: the anchor or the latest checkpoint")
    ap.add_argument("--offload", action="store_true",
                    help="keep the outer state in pinned host memory between outer events")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    # the reference's flags that the port does not run yet: they raise
    ap.add_argument("--kernel-backend", default="")
    ap.add_argument("--sharded-outer", action="store_true")
    ap.add_argument("--comm-chunks", type=int, default=1)
    return ap


def configs_from_args(args):
    """(ModelConfig, TrainConfig, ParallelConfig) from parsed flags; a flag
    the port does not run raises ``NotImplementedError``."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models.transformer import check_token_batches

    unported = {"--kernel-backend": bool(args.kernel_backend),
                "--sharded-outer": args.sharded_outer, "--comm-chunks": args.comm_chunks > 1}
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported to the PyTorch Trainer yet: {', '.join(asked)}")
    if (args.adaptive_sync or args.remeasure_every) and args.sync_delay != "auto":
        raise ValueError("--adaptive-sync / --remeasure-every need --sync-delay auto")
    mc = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    check_token_batches(mc, "the Trainer", "synthetic pipeline's")
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        pods, shape = (shape[0], shape[1:]) if len(shape) == 4 else (1, shape)
        if len(shape) != 3:
            raise ValueError(f"--mesh takes 3 or 4 sizes, got {args.mesh!r}")
    else:
        pods, shape = 1, (args.groups, 1, 1)
    pc = ParallelConfig(data_axis_size=shape[0] * shape[1], model_axis_size=shape[2],
                        num_pods=pods, data_outer=shape[0])
    tc = TrainConfig(optimizer=args.optimizer, total_steps=args.total_steps or args.steps,
                     global_batch_size=args.global_batch, seq_len=args.seq_len,
                     sync_interval=args.sync_interval,
                     sync_delay="auto" if args.sync_delay == "auto" else int(args.sync_delay),
                     inner_lr=args.lr, inner_min_lr=args.lr / 10, seed=args.seed,
                     lazy_start=args.optimizer != "diloco", offload_outer_state=args.offload,
                     membership=(MembershipConfig(max_staleness=args.max_staleness,
                                                  min_live=args.min_live,
                                                  rejoin_bootstrap=args.rejoin_bootstrap)
                                 if args.churn_script else None),
                     outer_comm=OuterCommConfig(compression=args.outer_compression,
                                                bits=args.outer_comm_bits,
                                                hierarchical=args.hierarchical_reduce))
    return mc, tc, pc


def main(argv=None):
    args = build_parser().parse_args(argv)
    mc, tc, pc = configs_from_args(args)
    from repro_torch.sync import resolve_strategy

    strategy = resolve_strategy(tc)
    world = pc.num_devices
    print(f"arch={mc.name} optimizer={tc.optimizer} pods={pc.num_pods} "
          f"groups={pc.num_groups} data_inner={pc.data_inner} ranks={world} "
          f"device={args.device} outer_sync={strategy.name}"
          + (f" churn={args.churn_script}" if args.churn_script else ""), flush=True)
    job = {"log_every": args.log_every, "churn": args.churn_script, "chip_hint": args.chip,
           "adaptive_sync": args.adaptive_sync, "remeasure_every": args.remeasure_every,
           "checkpoint_dir": args.checkpoint_dir or None, "ckpt_every": args.ckpt_every}
    joined = args.nproc == 0 and "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if joined:
        info = _init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                          resolve_device(args.device).type, "env://")
        try:
            out = train_job(info, mc, tc, pc, args.steps, **job)
        finally:
            dist.destroy_process_group()
        if info.rank != 0:
            return out
    else:
        nproc = args.nproc or world
        if nproc != world:
            raise ValueError(f"--nproc {nproc} but the layout has {world} ranks")
        out = spawn(train_job, (mc, tc, pc, args.steps), job, nproc=nproc,
                    device=args.device)[0]
    if tc.sync_delay == "auto":
        print(f"sync_delay=auto resolved to d*={out['sync_delay']} (chip="
              f"{args.chip or 'none'}; re-resolved from measured sync windows)", flush=True)
    print(json.dumps({"final_loss": out["history"][-1]["loss"], "steps": len(out["history"]),
                      "strategy": out["strategy"], "ranks": world}), flush=True)
    return out


if __name__ == "__main__":
    main()

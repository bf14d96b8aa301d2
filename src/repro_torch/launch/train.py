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

Not ported (they raise ``NotImplementedError``, as in ``SimulatedRun``):
``sync_delay="auto"`` and the sync controllers, elastic membership,
``switch_strategy``, outer-state offload, checkpoints, Chunked and
Sharded outer syncs.
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

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, OuterCommConfig, ParallelConfig, TrainConfig
from repro_torch.core.pier import PierSchedule
from repro_torch.kernels.symm import PEER_TIMEOUT_S
from repro_torch.parallel.steps import build_train_steps, mean_metrics

# Intra-op threads of a CPU rank. Ranks share the host with each other and
# with whatever else runs there; one thread each keeps an oversubscribed
# host from stalling every rank's parallel regions, and fixes the order
# in which CPU matmuls sum (which depends on the thread count).
CPU_THREADS = 1


class Trainer:
    """Host-side training loop of one rank, weaving inner and outer steps
    per the schedule, with one in-flight dispatch/apply window.

    ``params``: initial parameters in training storage (every rank the
    same); by default made from ``tc.seed`` on the mesh's device.
    """

    def __init__(self, mc: ModelConfig, tc: TrainConfig, pc: ParallelConfig, mesh, *,
                 params=None, strategy=None, checkpoint_dir: Optional[str] = None,
                 sync_controller=None, membership=None):
        for name, arg in (("checkpoint_dir", checkpoint_dir),
                          ("sync_controller", sync_controller), ("membership", membership),
                          ("TrainConfig.membership", tc.membership)):
            if arg is not None:
                raise NotImplementedError(f"Trainer: {name} is not ported yet")
        if tc.offload_outer_state:
            raise NotImplementedError("Trainer: outer-state offload is not ported yet")
        self.mc, self.tc, self.pc, self.mesh = mc, tc, pc, mesh
        self.bundle = build_train_steps(mc, tc, pc, mesh, strategy, params=params)
        self.strategy = self.bundle.strategy
        self.sched = PierSchedule(tc)
        self.state = self.bundle.init_state()
        self.outer = self.bundle.init_outer(self.state)
        self.step = 0
        self.history: List[Dict[str, float]] = []
        # the (single) in-flight window: (apply_at, "outer", DispatchState)
        # or (apply_at, "accumulate", pending OuterState)
        self._inflight = None

    def train_step(self, batch) -> Dict[str, Any]:
        """One scheduled step (inner or warmup) and its outer events.

        Returns this rank's metrics: ``loss`` and ``grad_norm`` as device
        tensors, not yet meaned over the world (:meth:`run` means them)."""
        sched, step = self.sched, self.step
        if sched.phase(step) == "warmup":
            metrics = self.bundle.warmup_step(self.state, batch, step)
        else:
            metrics = self.bundle.inner_step(self.state, batch, step)
        events = sched.events(step)
        fused_outer = any(ev.kind == "dispatch" and ev.op == "outer" and ev.apply_step == step
                          for ev in events)
        if fused_outer:
            self._apply_inflight()
            self.outer = self.bundle.outer_step(self.state, self.outer,
                                                sched.mu_at(step), sched.outer_lr_at(step))
        else:
            for ev in events:
                if ev.kind == "apply":
                    if self._inflight is not None and self._inflight[0] <= step:
                        self._apply_inflight()
                    continue
                self._apply_inflight()  # the window is free by the schedule
                if ev.op == "accumulate":
                    self._dispatch_accumulate(ev)
                else:
                    self._inflight = (ev.apply_step, "outer", self._dispatch(step))
            if self._inflight is not None and self._inflight[0] <= step:
                self._apply_inflight()
        self.step += 1
        return metrics

    def _dispatch_accumulate(self, ev):
        """Warmup accumulate: eager (``apply_step == sync_step``) installs
        the new outer state at once; delayed, the pending state installs
        at its apply (the correction is identically zero)."""
        pending = self.bundle.accumulate_step(self.state, self.outer,
                                              self.sched.mu_at(ev.sync_step))
        if ev.apply_step <= ev.sync_step:
            self.outer = pending
        else:
            self._inflight = (ev.apply_step, "accumulate", pending)

    def _dispatch(self, step: int):
        """Start the outer exchange of the boundary at ``step``; the
        dispatch-time parameters are copied when the apply lands later."""
        sched = self.sched
        return self.bundle.dispatch_step(self.state, self.outer, sched.mu_at(step),
                                         sched.outer_lr_at(step),
                                         snapshot=sched.apply_step_for(step) > step)

    def _apply_inflight(self):
        # a no-op when flush() already drained the window
        if self._inflight is None:
            return
        _, op, payload = self._inflight
        self._inflight = None
        if op == "accumulate":
            self.outer = payload
        else:
            self.outer = self.bundle.apply_step(self.state, self.outer, payload)

    def flush(self):
        """Drain an in-flight dispatch (end of run)."""
        if self._inflight is not None:
            self._apply_inflight()

    def run(self, steps: int, pipeline, *, log_every: int = 10):
        """Run ``steps`` steps; the history holds each step's world-mean
        loss and gradient norm, meaned in one collective at every log step
        and at the end (the inner steps themselves wait for no other group)."""
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
        self.history += mean_metrics(local, self.mesh.world_size)
        self.flush()
        return self.history

    def eval_loss(self, batch) -> float:
        """The loss of this rank's replica on ``batch``, meaned over the world."""
        return self.bundle.eval_step(self.state, batch)

    def close(self):
        """Free the symmetric buffers (collective)."""
        self.bundle.close()


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

    return {"flash_attention": (FK, "launches"), "flash_attention_bwd": (FK, "bwd_launches"),
            "flash_attention_tc": (FK, "tc_launches"),
            "flash_attention_bwd_tc": (FK, "tc_bwd_launches"),
            "quantize_blockwise": (QK, "launches"),
            "dequantize_blockwise": (QK, "dequantize_launches"),
            "pier_update": (PK, "launches"), "ring_allgather": (RA, "ring_launches"),
            "shard_scatter": (RA, "scatter_launches")}


def train_job(info: RankInfo, mc: ModelConfig, tc: TrainConfig, pc: ParallelConfig,
              steps: int, *, params=None, batches=None, keep_params: bool = False,
              val_batch=None, timed: bool = False, log_every: int = 0) -> Dict[str, Any]:
    """Build the mesh and a :class:`Trainer` on this rank and run ``steps``.

    ``params``: a state dict of initial parameters (CPU tensors), made
    from ``tc.seed`` when absent. ``batches``: global batches (dicts of
    CPU tensors) to feed instead of the synthetic pipeline's. ``val_batch``:
    a batch whose world-mean loss is taken before and after the run.
    ``timed``: host times of each step kind (after a synchronize), of one
    step's world metric mean (``metric_mean``, five calls after the run) and
    peak device memory. Returns this rank's history, launch counts and, with
    ``keep_params``, its final parameters and residuals on the CPU.
    """
    from repro_torch.data.pipeline import DataPipeline, synthetic_pipeline
    from repro_torch.launch.mesh import make_pier_mesh
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    mesh = make_pier_mesh(pc, device=info.device)
    p0 = None
    if params is not None:
        p0 = R.init_params(mc, seed=0, device="cpu", training=True)
        p0.load_state_dict(params)
    cuda = info.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(info.device)
    t_init = time.perf_counter()
    trainer = Trainer(mc, tc, pc, mesh, params=p0)
    t_init = time.perf_counter() - t_init
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
    if batches is None:
        pipe = synthetic_pipeline(mc, tc, rank=mesh.rank, world=mesh.world_size,
                                  device=info.device, stop=steps)
    else:
        pipe = DataPipeline(lambda s: batches[s], rank=mesh.rank, world=mesh.world_size,
                            device=info.device, stop=steps)
    counts = _launch_counts()
    for mod, attr in counts.values():
        setattr(mod, attr, 0)
    from repro_torch.kernels import ring_allreduce as RA

    RA.event_log = [] if timed and cuda else None
    try:
        t0 = time.perf_counter()
        hist = trainer.run(steps, pipe, log_every=log_every)
        if cuda:
            torch.cuda.synchronize(info.device)
        wall = time.perf_counter() - t0
    finally:
        pipe.close()
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
           "device": str(info.device), **val}
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(info.device)
    if keep_params:
        out["params"] = [t.detach().cpu().clone() for _, t in param_leaves(trainer.state.params)]
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
    run the ranks' start-up."""
    return [train_job(info, *a, **k) for a, k in jobs]


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
                    help="overlap the outer exchange with this many inner steps "
                         "(0 = eager; 'auto' is not ported)")
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
    # the reference's flags that the port does not run yet: they raise
    for flag in ("--chip", "--churn-script", "--checkpoint-dir", "--kernel-backend"):
        ap.add_argument(flag, default="")
    for flag in ("--adaptive-sync", "--offload", "--sharded-outer"):
        ap.add_argument(flag, action="store_true")
    for flag in ("--remeasure-every", "--ckpt-every"):
        ap.add_argument(flag, type=int, default=0)
    ap.add_argument("--comm-chunks", type=int, default=1)
    return ap


def configs_from_args(args):
    """(ModelConfig, TrainConfig, ParallelConfig) from parsed flags; a flag
    the port does not run raises ``NotImplementedError``."""
    from repro_torch.configs import get_config, get_reduced_config

    unported = {"--sync-delay auto": args.sync_delay == "auto", "--chip": bool(args.chip),
                "--adaptive-sync": args.adaptive_sync,
                "--remeasure-every": bool(args.remeasure_every),
                "--churn-script": bool(args.churn_script), "--offload": args.offload,
                "--checkpoint-dir": bool(args.checkpoint_dir),
                "--ckpt-every": bool(args.ckpt_every),
                "--kernel-backend": bool(args.kernel_backend),
                "--sharded-outer": args.sharded_outer, "--comm-chunks": args.comm_chunks > 1}
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"not ported to the PyTorch Trainer yet: {', '.join(asked)}")
    mc = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
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
                     sync_interval=args.sync_interval, sync_delay=int(args.sync_delay),
                     inner_lr=args.lr, inner_min_lr=args.lr / 10, seed=args.seed,
                     lazy_start=args.optimizer != "diloco",
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
          f"device={args.device} outer_sync={strategy.name}", flush=True)
    joined = args.nproc == 0 and "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if joined:
        info = _init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                          resolve_device(args.device).type, "env://")
        try:
            out = train_job(info, mc, tc, pc, args.steps, log_every=args.log_every)
        finally:
            dist.destroy_process_group()
        if info.rank != 0:
            return out
    else:
        nproc = args.nproc or world
        if nproc != world:
            raise ValueError(f"--nproc {nproc} but the layout has {world} ranks")
        out = spawn(train_job, (mc, tc, pc, args.steps), {"log_every": args.log_every},
                    nproc=nproc, device=args.device)[0]
    print(json.dumps({"final_loss": out["history"][-1]["loss"], "steps": len(out["history"]),
                      "strategy": out["strategy"], "ranks": world}), flush=True)
    return out


if __name__ == "__main__":
    main()

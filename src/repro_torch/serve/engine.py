"""Continuous-batching serve engine over the paged KV pool.

Counterpart of ``repro/serve/engine.py``: the same loop, admission policy,
host-side numpy sampling and ``stats``. Each :meth:`ServeEngine.step` is:

1. **Admission**: pop waiting requests into free slots while the free list
   can cover every block a request can ever need (padded prompt +
   ``max_new_tokens``), allocated up front, so an admitted sequence never
   hits pool exhaustion; ``token_budget`` caps the summed live tokens.
2. **Prefill**: newly admitted prompts run one at a time (B=1) through
   ``prefill_step``, right-padded to a block multiple; the first token is
   sampled from the last real position's logits.
3. **Decode**: one batched ``decode_step`` over all ``max_slots`` slots;
   empty slots carry ``context_len 0`` and compute into the sink block.
4. **Completion**: sequences reaching ``max_new_tokens`` (or ``eos_id``)
   leave their slot and return their blocks to the pool.

``continuous=False`` degrades to static batching (admission only when every
slot is empty). Latency accounting is wall-clock per engine step; reading
the logits back to the host waits for the device, so the times are of
finished work.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serve import kv_cache as KC


@dataclass
class EngineConfig:
    max_slots: int = 4           # batched-decode width
    max_new_tokens: int = 32     # default per-request cap
    token_budget: int = 0        # cap on summed live tokens; 0 = pool-bound
    continuous: bool = True      # False = static-batching baseline
    greedy: bool = True
    temperature: float = 1.0
    eos_id: int = -1             # -1 = never; requests run to max_new_tokens
    seed: int = 0                # sampling stream (greedy=False)
    max_blocks_per_seq: int = 0  # block-table width; 0 = whole pool


@dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0         # trace timestamp (bench bookkeeping)


@dataclass
class RequestResult:
    uid: int
    prompt_len: int
    tokens: List[int]
    arrival: float
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    token_times: List[float] = field(default_factory=list)


@dataclass
class _Seq:
    """A live sequence occupying a decode slot."""

    req: Request
    blocks: List[int]            # all reserved physical blocks, in order
    pos: int                     # absolute position of the NEXT token fed
    next_token: int
    result: RequestResult


class ServeEngine:
    """Continuous-batching engine; see the module docstring for the loop."""

    def __init__(self, params, cfg: ModelConfig, bundle,
                 pcfg: KC.PagedCacheConfig, ecfg: EngineConfig):
        ok, why = KC.paged_supported(cfg)
        if not ok:
            raise ValueError(f"paged serving unsupported for {cfg.name}: {why}")
        T.check_ported(cfg)
        self.params = params
        self.cfg = cfg
        self.bundle = bundle
        self.device = bundle.device
        self.pcfg = pcfg
        self.ecfg = ecfg
        self.alloc = KC.BlockAllocator(pcfg.num_blocks)
        self.pools = bundle.init_pools()
        self.waiting: deque = deque()
        self.slots: List[Optional[_Seq]] = [None] * ecfg.max_slots
        self._rng = np.random.default_rng(ecfg.seed)
        self._uid = 0
        # block-table width = the longest admissible sequence in blocks
        self.table_width = ecfg.max_blocks_per_seq or (pcfg.num_blocks - 1)
        self.finished: List[RequestResult] = []
        self._next_params = None  # set_params' swap, installed at the next step
        self.stats: Dict[str, Any] = {
            "steps": 0, "prefills": 0, "decode_steps": 0,
            "tokens_out": 0, "peak_blocks": 0,
        }

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               arrival: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._uid += 1
        self.waiting.append(Request(
            uid=self._uid, prompt=prompt,
            max_new_tokens=max_new_tokens or self.ecfg.max_new_tokens,
            arrival=arrival))
        return self._uid

    # -- admission policy ----------------------------------------------------

    def _blocks_needed(self, req: Request) -> int:
        padded = -(-len(req.prompt) // self.pcfg.block_size) * self.pcfg.block_size
        return self.pcfg.blocks_for(padded + req.max_new_tokens)

    def _live_tokens(self) -> int:
        return sum(s.pos for s in self.slots if s is not None)

    def _admissible(self, req: Request) -> bool:
        need = self._blocks_needed(req)
        if need > self.table_width:
            raise ValueError(
                f"request {req.uid} needs {need} blocks > pool capacity "
                f"{self.table_width}")
        if need > self.alloc.num_free:
            return False
        budget = self.ecfg.token_budget
        if budget and self._live_tokens() + len(req.prompt) > budget:
            return False
        return True

    # -- engine iteration ----------------------------------------------------

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.ecfg.greedy:
            return int(np.argmax(logits_row))
        z = logits_row / max(self.ecfg.temperature, 1e-6)
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _admit_and_prefill(self, now: float) -> None:
        if not self.ecfg.continuous and any(s is not None for s in self.slots):
            return  # static batching: wait for the whole wave to drain
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.waiting:
                continue
            if not self._admissible(self.waiting[0]):
                break  # FIFO: don't let short requests starve long ones
            req = self.waiting.popleft()
            blocks = self.alloc.alloc_many(self._blocks_needed(req))
            bs = self.pcfg.block_size
            S = len(req.prompt)
            padded = -(-S // bs) * bs
            prompt = np.zeros((1, padded), np.int32)
            prompt[0, :S] = req.prompt
            logits, self.pools = self.bundle.prefill_step(
                self.params, self._to_device(prompt), self.pools,
                self._to_device(np.asarray(blocks[: padded // bs], np.int32)),
                S - 1)
            first = self._sample(logits[0].float().cpu().numpy())
            t_first = time.perf_counter()
            res = RequestResult(
                uid=req.uid, prompt_len=S, tokens=[first],
                arrival=req.arrival, admitted_at=now, first_token_at=t_first)
            res.token_times.append(t_first)
            self.slots[i] = _Seq(req=req, blocks=blocks, pos=S,
                                 next_token=first, result=res)
            self.stats["prefills"] += 1
            self.stats["tokens_out"] += 1

    def _decode_batch(self) -> None:
        B = self.ecfg.max_slots
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        context = np.zeros((B,), np.int32)
        tables = np.full((B, self.table_width), -1, np.int32)
        live = False
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            live = True
            tokens[i] = s.next_token
            positions[i] = s.pos
            context[i] = s.pos + 1
            tables[i, : len(s.blocks)] = s.blocks
        if not live:
            return
        logits, self.pools = self.bundle.decode_step(
            self.params, self.pools, self._to_device(tokens),
            self._to_device(positions), self._to_device(tables),
            self._to_device(context))
        logits = logits.float().cpu().numpy()
        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = self._sample(logits[i])
            s.pos += 1
            s.result.tokens.append(tok)
            s.result.token_times.append(now)
            s.next_token = tok
            self.stats["tokens_out"] += 1
            done = (len(s.result.tokens) >= s.req.max_new_tokens
                    or tok == self.ecfg.eos_id)
            if done:
                s.result.finished_at = now
                self.alloc.free_many(s.blocks)
                self.finished.append(s.result)
                self.slots[i] = None
        self.stats["decode_steps"] += 1

    def step(self) -> bool:
        """One engine iteration. Returns True while work remains."""
        if self._next_params is not None:  # a swap lands on the step boundary
            self.params, self._next_params = self._next_params, None
        now = time.perf_counter()
        self._admit_and_prefill(now)
        in_use = self.alloc.num_free
        self.stats["peak_blocks"] = max(
            self.stats["peak_blocks"],
            (self.pcfg.num_blocks - 1) - in_use)
        self._decode_batch()
        self.stats["steps"] += 1
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def run(self, on_step: Optional[Callable[["ServeEngine"], None]] = None,
            max_steps: int = 100000) -> List[RequestResult]:
        """Drive :meth:`step` until the queue drains; ``on_step`` runs
        between engine steps."""
        for _ in range(max_steps):
            if on_step is not None:
                on_step(self)
            if not self.step():
                break
        else:
            raise RuntimeError("engine did not drain within max_steps")
        return sorted(self.finished, key=lambda r: r.uid)

    # -- hot handoff ---------------------------------------------------------

    def set_params(self, params) -> None:
        """Swap the served parameters (``serve/handoff.py`` calls it between
        steps); the swap takes effect at the next step boundary. In-flight
        sequences keep their KV blocks, cached by the old parameters;
        requests admitted after the swap run on the new ones alone. A tree
        whose leaf names, shapes, dtypes (serving storage) or device differ
        from the served one is refused."""
        def layout(p):
            return [(n, tuple(t.shape), t.dtype, t.device) for n, t in T.param_leaves(p)]

        have, got = layout(self.params), layout(params)
        if got != have:
            diff = [(h, g) for h, g in zip(have, got) if h != g][:3]
            raise ValueError(f"set_params: the new parameters do not match the served ones "
                             f"({len(got)} leaves for {len(have)}; first differences "
                             f"(served, new): {diff})")
        self._next_params = params

    # -- occupancy -----------------------------------------------------------

    @property
    def occupancy(self) -> float:
        usable = self.pcfg.num_blocks - 1
        return (usable - self.alloc.num_free) / usable


# ---------------------------------------------------------------------------
# generate() helper (launch/serve.py)
# ---------------------------------------------------------------------------


def generate(params, cfg: ModelConfig, prompts, num_tokens: int, *,
             greedy: bool = True, temperature: float = 1.0, seed: int = 0,
             pcfg: Optional[KC.PagedCacheConfig] = None, on_step=None, frames=None):
    """Generate ``num_tokens`` per prompt row, on the device the params
    lie on. Returns ((B, num_tokens) np.int32, info dict). ``on_step``:
    called with the engine between steps, as :meth:`ServeEngine.run` does
    (e.g. ``CheckpointPoller.on_step``). ``frames``: an encoder-decoder's
    (B, S_enc, d_model) frame embeddings (a tensor or an array), which it
    needs (``ValueError`` without them, as ``repro/serve/engine.py:332-335``).

    Paged-supported architectures go through the continuous-batching engine
    (one request per prompt row; ``info["path"] == "paged"``). The others
    (models with recurrent blocks, MLA attention or an encoder) take the
    dense path of the reference
    (``repro/serve/engine.py:328-356``): a static batch with lockstep
    positions through ``build_serve_steps``, one prefill of all the rows,
    then a decode step a token, sampled on the host from a numpy
    ``default_rng(seed)`` (``info["path"] == "dense"``). That path has no
    engine steps, so ``on_step`` and a paged-cache config raise there.
    """
    from repro_torch.parallel.steps import build_paged_serve_steps, build_serve_steps

    prompts = np.asarray(prompts, np.int32)
    B, S = prompts.shape
    device = params["embed"]["tokens"].device
    ok, why = KC.paged_supported(cfg)
    if not ok:
        if on_step is not None or pcfg is not None:
            raise ValueError(f"{cfg.name} serves through the dense path ({why}), which has "
                             f"no engine steps for on_step and no paged KV cache for pcfg")
        batch_in = {"tokens": torch.from_numpy(prompts).to(device)}
        if cfg.is_encoder_decoder:
            if frames is None:
                raise ValueError(f"{cfg.name}: encoder-decoder serving needs frames")
            batch_in["frames"] = torch.as_tensor(frames).to(device)
        bundle = build_serve_steps(cfg, batch=B, max_len=S + num_tokens, device=device)
        out, times = _generate_dense(bundle, params, batch_in, num_tokens, greedy=greedy,
                                     temperature=temperature, seed=seed)
        return out, {"path": "dense", "bundle": bundle, "token_times": times}
    if pcfg is None:
        bs = KC.PagedCacheConfig().block_size
        padded = -(-S // bs) * bs
        need = KC.PagedCacheConfig().blocks_for(padded + num_tokens)
        pcfg = KC.PagedCacheConfig(num_blocks=need * B + 1)
    need = pcfg.blocks_for(-(-S // pcfg.block_size) * pcfg.block_size + num_tokens)
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device=device)
    engine = ServeEngine(params, cfg, bundle, pcfg, EngineConfig(
        max_slots=B, max_new_tokens=num_tokens, greedy=greedy,
        temperature=temperature, seed=seed, max_blocks_per_seq=need))
    for b in range(B):
        engine.submit(prompts[b], num_tokens)
    results = engine.run(on_step=on_step)
    out = np.stack([np.asarray(r.tokens[:num_tokens], np.int32) for r in results])
    return out, {"path": "paged", "engine": engine}


def _generate_dense(bundle, params, batch_in, num_tokens: int, *, greedy: bool,
                    temperature: float, seed: int):
    """The dense path's loop over the prefill's batch (``tokens`` and, for
    an encoder-decoder, ``frames``, on the bundle's device) -> ((B,
    num_tokens) np.int32, times): ``times`` holds the host clock
    (``time.perf_counter``) before the prefill, then after each of the
    ``num_tokens`` steps' tokens were sampled (reading the logits back
    waits for the device, so these are of finished work)."""
    B = batch_in["tokens"].shape[0]
    rng = np.random.default_rng(seed)

    def sample(logits):
        arr = logits[:, -1].float().cpu().numpy()  # (B, V)
        if greedy:
            return np.argmax(arr, axis=-1).astype(np.int32)
        z = arr / max(temperature, 1e-6)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
        return np.stack([rng.choice(arr.shape[-1], p=p[b]) for b in range(B)]).astype(np.int32)

    times = [time.perf_counter()]
    logits, state = bundle.prefill_step(params, batch_in)
    next_tok = sample(logits)
    times.append(time.perf_counter())
    generated = [next_tok]
    for _ in range(num_tokens - 1):
        tokens = torch.from_numpy(next_tok[:, None]).to(bundle.device)
        logits, state = bundle.serve_step(params, state, tokens)
        next_tok = sample(logits)
        times.append(time.perf_counter())
        generated.append(next_tok)
    return np.stack(generated, axis=1), times

"""The Trainer's input pipeline (``repro/data/pipeline.py``).

:class:`DataPipeline` makes the global batch of every step on a background
thread and hands this rank its rows, moved to its device. The global batch
is laid out row-major over ``(pod, data_outer, data_inner)``, the order
the ranks are numbered in (``launch/mesh.py``), so rank ``r`` of ``W``
keeps rows ``[r * B / W, (r + 1) * B / W)``: each Pier group reads a
disjoint slice of the stream, split again over its ``data_inner`` ranks.

:func:`synthetic_pipeline` makes the batches as
``core/simulate.py:SimulatedRun._global_batch`` does (the same MarkovLM
tables, the same ``torch.Generator`` seed per step), so group ``g`` reads
exactly the rows the simulator gives its group ``g``. The reference samples
its walks with jax's threefry, which PyTorch does not have; only the
tables are the reference's.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.synthetic import MarkovLM, make_train_batch

# Global batches made ahead of the step that reads them.
PREFETCH = 2


def rank_rows(global_batch: int, rank: int, world: int) -> slice:
    """This rank's rows of the global batch (row-major over the layout)."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


class DataPipeline:
    """Iterator of this rank's training batches.

    ``make_batch(step)`` gives the global batch (a dict of CPU tensors,
    dim 0 the batch); ``PREFETCH`` batches are made ahead on a thread, from
    step ``start`` up to step ``stop`` (exclusive) when it is given.
    """

    def __init__(self, make_batch: Callable[[int], Dict[str, torch.Tensor]], *, rank: int,
                 world: int, device, stop: Optional[int] = None, start: int = 0):
        self.make_batch = make_batch
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._end = stop
        self._start = start
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def local(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch."""
        return {k: v[rank_rows(v.shape[0], self.rank, self.world)] for k, v in batch.items()}

    def _producer(self):
        step = self._start
        while not self._stop.is_set() and (self._end is None or step < self._end):
            item = self.local(self.make_batch(step))
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self._q.get()
        return {k: v.to(self.device) for k, v in batch.items()}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def global_batch_fn(mc: ModelConfig, tc: TrainConfig):
    """``step -> global batch``, as ``SimulatedRun._global_batch``."""
    lm = MarkovLM(mc.vocab_size, seed=1234)

    def make(step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed((tc.seed << 32) + step)
        return make_train_batch(lm, gen, tc.global_batch_size, tc.seq_len)

    return make


def synthetic_pipeline(mc: ModelConfig, tc: TrainConfig, *, rank: int, world: int, device,
                       stop: Optional[int] = None, start: int = 0) -> DataPipeline:
    """The MarkovLM pipeline of {"tokens", "labels"} batches for this rank."""
    return DataPipeline(global_batch_fn(mc, tc), rank=rank, world=world, device=device,
                        stop=stop, start=start)

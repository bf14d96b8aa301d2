"""The Pier process layout on ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py`` (``make_pier_mesh``; its
``axis_sizes`` is :func:`layout_sizes`). The reference lays a device mesh
out as ``(pod, data_outer, data_inner, model)`` and lets ``shard_map`` name
the manual (group) axes; here every rank is one process, ranked row-major over
``(pod, data_outer, data_inner)`` exactly as the reference linearises its
axes, and the axes become process groups:

- ``group``: the ``data_inner`` ranks of one Pier group (``(pod,
  data_outer)`` index), where the inner step means its gradients;
- ``exchange``: the ranks with this rank's ``data_inner`` index in every
  group, in canonical source order (group index ``g = pod * data_outer +
  data_outer_index``): the outer sync's exchange;
- ``fast`` and ``slow``: the same ranks split by pod, for the hierarchical
  reduce (stage 1 inside the pod, stage 2 across pods);
- ``world``: the default group (the warmup step's global gradient mean).

``torch.distributed.new_group`` is collective, so every rank creates every
group in the same order. The model axis is 1 (``ParallelConfig`` raises
otherwise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ParallelConfig

AXES = ("pod", "data_outer", "data_inner")


def backend_for(device: torch.device, world_size: int, devices_per_host: int) -> str:
    """``gloo`` on the CPU and whenever ranks share a card; ``nccl`` only
    when every rank has a card of its own (NCCL refuses two ranks on one
    card). A choice made from the layout, not a fallback."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world_size <= devices_per_host else "gloo"


def layout_sizes(pc: ParallelConfig) -> Dict[str, int]:
    """Axis sizes of the rank layout (the reference's ``axis_sizes``)."""
    return {"pod": max(pc.num_pods, 1), "data_outer": pc.data_outer,
            "data_inner": pc.data_inner}


def coords_of(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Row-major coordinates of ``rank`` over ``AXES``."""
    out = {}
    for ax in reversed(AXES):
        out[ax] = rank % sizes[ax]
        rank //= sizes[ax]
    return {ax: out[ax] for ax in AXES}


@dataclass
class PierMesh:
    """This rank's place in the layout and its process groups.

    Each ``*_ranks`` lists a group's global ranks in canonical source order
    (``None`` stands for a group of one): ``exchange`` over every group,
    ``slow`` over the pods (the hierarchical stage 2), ``fast`` the groups
    of this pod (stage 1), all with this rank's ``data_inner`` index.
    """

    pc: ParallelConfig
    rank: int
    world_size: int
    device: torch.device
    backend: str
    sizes: Dict[str, int]
    coords: Dict[str, int]
    group: object
    group_ranks: List[int]
    exchange: object
    exchange_ranks: List[int]
    fast: object
    fast_ranks: List[int]
    slow: object
    slow_ranks: List[int]

    @property
    def group_index(self) -> int:
        """This rank's Pier group, its canonical source index."""
        return self.coords["pod"] * self.sizes["data_outer"] + self.coords["data_outer"]


def make_pier_mesh(pc: ParallelConfig, *, device: torch.device) -> PierMesh:
    """Build the layout over the initialised default process group.

    The world must hold exactly ``pc.num_devices`` ranks.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_pier_mesh needs torch.distributed initialised")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != pc.num_devices:
        raise ValueError(f"the layout needs {pc.num_devices} ranks "
                         f"(pods {pc.num_pods} x data {pc.data_axis_size}), the world has "
                         f"{world}")
    sizes = layout_sizes(pc)
    me = coords_of(rank, sizes)

    def ranks_where(**fixed) -> List[int]:
        return [r for r in range(world)
                if all(coords_of(r, sizes)[a] == v for a, v in fixed.items())]

    def make(partition) -> Tuple[object, List[int]]:
        # every rank creates every group of the partition, in order
        mine = None
        for ranks in partition:
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                mine = (pg, ranks)
        return mine

    P, O, I = sizes["pod"], sizes["data_outer"], sizes["data_inner"]
    group = make([ranks_where(pod=p, data_outer=o) for p in range(P) for o in range(O)])
    exchange = make([ranks_where(data_inner=i) for i in range(I)])
    fast = make([ranks_where(pod=p, data_inner=i) for p in range(P) for i in range(I)])
    slow = make([ranks_where(data_outer=o, data_inner=i) for o in range(O) for i in range(I)])
    return PierMesh(pc=pc, rank=rank, world_size=world, device=device,
                    backend=dist.get_backend(), sizes=sizes, coords=me,
                    group=group[0], group_ranks=group[1],
                    exchange=exchange[0], exchange_ranks=exchange[1],
                    fast=fast[0], fast_ranks=fast[1], slow=slow[0], slow_ranks=slow[1])


# ---------------------------------------------------------------------------
# the fp32 collective helper
# ---------------------------------------------------------------------------


class MeanWork:
    """An fp32 mean over a process group, started asynchronously.

    The tensors are flattened into one buffer so that a tree takes one
    collective. gloo stages a CUDA tensor through the host for its
    collectives; the helper does that explicitly (one device-to-host copy
    when the work starts, one host-to-device copy in :meth:`wait`), so the
    same code runs on every build. The mean is the sum divided by the group
    size, as ``torch.mean`` computes it.
    """

    def __init__(self, tensors, group, size: int):
        self.shapes = [t.shape for t in tensors]
        self.size = size
        flat = torch.cat([t.reshape(-1).float() for t in tensors]) if tensors else \
            torch.zeros(0)
        self.device = flat.device
        self._buf = flat
        self._work = None
        if size > 1:
            stage = flat.device.type == "cuda" and dist.get_backend(group) == "gloo"
            self._buf = flat.cpu() if stage else flat
            self._work = dist.all_reduce(self._buf, group=group, async_op=True)

    def wait(self):
        """The means, one tensor per input, on the inputs' device."""
        if self._work is not None:
            self._work.wait()
            self._buf.div_(self.size)
        flat = self._buf.to(self.device)
        out, off = [], 0
        for shape in self.shapes:
            n = 1
            for d in shape:
                n *= int(d)
            out.append(flat[off:off + n].view(shape))
            off += n
        return out


def mean_(tensors, group, size: int) -> None:
    """Replace each tensor by its mean over ``group``, in place (blocking)."""
    if size <= 1:
        return
    for t, m in zip(tensors, MeanWork(tensors, group, size).wait()):
        t.copy_(m)

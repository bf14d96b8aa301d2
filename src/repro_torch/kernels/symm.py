"""Symmetric buffers of the wire exchange, mapped between processes.

Every member of an exchange group allocates one device buffer with
``cudaMalloc`` in the kernel library (``csrc/ipc.cu``), not in PyTorch's
caching allocator: an IPC handle names a whole allocation, and the handle
of a cached sub-block would open at its segment's base. The members swap
their ``cudaIpcMemHandle_t`` through the group's ``all_gather_object`` and
open their peers' handles, so each holds every member's buffer address.
Ranks on one card map each other's buffers the same way as ranks on
several cards of one host (then peer-to-peer).

A buffer is a signal pad followed by E slots of data (``csrc/symm.cuh``
gives the layout). It is sized once per run, from the largest wire
payload, and closed by :meth:`SymmBuffer.close`. Each launch advances the
buffer's epoch; every member launches the same sequence, so the epochs
agree. A kernel that misses its deadline writes an error code into a
host-mapped flag; :meth:`SymmBuffer.check` raises on it.

The :class:`Exchange` names what a wire exchange runs over: a process
group, its members in canonical source order, this member's index, and
(on the card) the symmetric buffer.
"""

from __future__ import annotations

import ctypes
import socket
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.kernels import _build

# Deadline, in seconds, of every wait on a peer: the Trainer's
# torch.distributed collectives (``launch/train.py``) and the wire kernels'
# in-kernel waits alike. A live peer may lag by whole steps (its warmup, an
# eval, ranks time-sliced on one card); only a dead or diverged one passes it.
PEER_TIMEOUT_S = 300.0
PAD_BYTES = 8192  # csrc/symm.cuh: kPadBytes
MAX_RANKS = 8  # csrc/symm.cuh: kMaxRanks
ERRORS = {1: "a peer never signalled ready (it did not launch its half of the exchange)",
          2: "a peer's data never arrived"}


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


class SymmBuffer:
    """One member's symmetric buffer and its peers' mapped addresses.

    Collective: every member of ``group`` constructs it with the same
    ``capacity`` (bytes of the data region, at least E slots of the largest
    payload).
    """

    def __init__(self, group, size: int, index: int, capacity: int, device: torch.device):
        import torch.distributed as dist

        if device.type != "cuda":
            raise ValueError(f"symmetric buffers live on a CUDA device, not {device}")
        if not 2 <= size <= MAX_RANKS:
            raise ValueError(f"the wire kernels take 2..{MAX_RANKS} members, got {size}")
        lib = _build.lib()
        self.device, self.size, self.index = device, size, index
        self.capacity = align16(int(capacity))
        self._dev = device.index if device.index is not None else torch.cuda.current_device()
        self.epoch = 0
        self._lib = lib
        self._base = ctypes.c_void_p()
        _build.check(lib.symm_alloc(self._dev, PAD_BYTES + self.capacity,
                                    ctypes.byref(self._base)), "symm_alloc")
        handle = ctypes.create_string_buffer(lib.ipc_handle_bytes())
        _build.check(lib.ipc_get_handle(self._base, ctypes.cast(handle, ctypes.c_void_p)),
                     "cudaIpcGetMemHandle")
        mine = (socket.gethostname(), self.capacity, bytes(handle.raw))
        every: List = [None] * size
        dist.all_gather_object(every, mine, group=group)
        hosts = {h for h, _, _ in every}
        if len(hosts) != 1:
            self._free_own()
            raise RuntimeError(
                f"the wire exchange maps its peers' buffers with CUDA IPC, which needs "
                f"every member on one host; members are on {sorted(hosts)}")
        if len({c for _, c, _ in every}) != 1:
            self._free_own()
            raise ValueError(f"members asked for different capacities: "
                             f"{[c for _, c, _ in every]}")
        self._opened = []
        peers = (ctypes.c_void_p * size)()
        for j, (_, _, h) in enumerate(every):
            if j == index:
                peers[j] = self._base.value
                continue
            p = ctypes.c_void_p()
            hb = ctypes.create_string_buffer(h, len(h))
            _build.check(lib.ipc_open_handle(self._dev, ctypes.cast(hb, ctypes.c_void_p),
                                             ctypes.byref(p)),
                         "cudaIpcOpenMemHandle")
            self._opened.append(p)
            peers[j] = p.value
        self.peers = peers
        self._flag_host = ctypes.c_void_p()
        self._flag_dev = ctypes.c_void_p()
        _build.check(lib.host_flag_alloc(ctypes.byref(self._flag_host),
                                         ctypes.byref(self._flag_dev)), "cudaHostAlloc")
        self._group = group
        self.closed = False

    @property
    def flag(self) -> ctypes.c_void_p:
        """Device address of the error flag (host-mapped)."""
        return self._flag_dev

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def error(self) -> int:
        """The flag's value: 0, or the code of the first missed deadline.
        Meaningful once the launches before it have completed."""
        return ctypes.c_int.from_address(self._flag_host.value).value

    def check(self, what: str = "wire exchange") -> None:
        err = self.error()
        if err:
            raise RuntimeError(f"{what}: {ERRORS.get(err, f'error {err}')} within the "
                               f"kernel's deadline (epoch {self.epoch})")

    def _free_own(self) -> None:
        _build.check(self._lib.symm_free(self._dev, self._base), "cudaFree")

    def close(self) -> None:
        """Collective: unmap the peers, wait for every member, free our own."""
        import torch.distributed as dist

        if self.closed:
            return
        torch.cuda.synchronize(self.device)
        for p in self._opened:
            _build.check(self._lib.ipc_close_handle(self._dev, p), "cudaIpcCloseMemHandle")
        dist.barrier(group=self._group)
        self._free_own()
        _build.check(self._lib.host_flag_free(self._flag_host), "cudaFreeHost")
        self.closed = True


@dataclass
class Exchange:
    """What a wire exchange runs over.

    ``group`` is the ``torch.distributed`` process group of the members
    (``None`` when there is one), ``ranks`` their global ranks in canonical
    source order, ``index`` this member's place in it. ``symm`` is the
    symmetric buffer a CUDA exchange needs; a CPU exchange has none.
    """

    group: object
    ranks: List[int]
    index: int
    symm: Optional[SymmBuffer] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

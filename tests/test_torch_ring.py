"""The port's wire exchange between processes against the reference's ring
transports, on the CPU.

One world of four ranks is spawned through the port's launcher (gloo, a
``FileStore`` under ``tmp_path``, a 60 s deadline); it holds exchange groups
of 2, 3 and 4 members. On the CPU the ring all-gather and shard-scatter
wrappers take their plain versions (``kernels/ref.py``: a gloo all-gather,
and an all-gather of the slot stacks and this member's column). Each member
feeds its rows of the same numpy inputs, made from a seed: packed int8 and
int4 wire with block 256 and 64 and ragged leaf lengths, one byte, several
leaves packed into one launch. The reference runs its ``ring``
transports under ``jax.vmap(axis_name=...)`` on the same inputs, as
``tests/test_int8_wire.py`` and ``tests/test_rs_ag_wire.py`` do. Every
comparison is byte for byte (bit for bit for fp32): the transports move
bytes, and the reductions sum in canonical source order on both sides.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels import ring_allreduce as JRA  # noqa: E402
from repro_torch.kernels import ring_allreduce as RA  # noqa: E402
from repro_torch.kernels.symm import Exchange  # noqa: E402
from repro_torch.kernels.wire import pack_wire as pt_pack  # noqa: E402
from repro_torch.kernels.wire import shard_slot_wire  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402

SIZES = (2, 3, 4)
# (bits, block, leaf lengths): several leaves go through one launch
CASES = [(8, 256, (1000,)), (4, 64, (300,)), (8, 64, (301, 1))]


@functools.lru_cache(maxsize=None)
def _inputs(E, case):
    """Per member and leaf: the reference quantizer's (q, scales) of a seeded
    normal vector, and a second quantized slot payload (q2, s2)."""
    bits, block, lengths = CASES[case]
    rng = np.random.default_rng(100 * E + case)
    leaves = []
    for n in lengths:
        x = rng.standard_normal((E, n)).astype(np.float32)
        q, s = zip(*[JR.quantize_blockwise_ref(jnp.asarray(x[j]), bits=bits, block=block)
                     for j in range(E)])
        sb = JR.wire_shard_blocks(int(s[0].shape[0]), E)
        x2 = rng.standard_normal((E, sb * block)).astype(np.float32)
        q2, s2 = zip(*[JR.quantize_blockwise_ref(jnp.asarray(x2[j]), bits=bits, block=block)
                       for j in range(E)])
        leaves.append(tuple(np.stack([np.asarray(a) for a in t]) for t in (q, s, q2, s2)))
    raw = rng.integers(0, 256, (E, 1 + 13 * case), dtype=np.uint8)  # 1, 14, 27 bytes
    return leaves, raw


def worker(info, inputs):
    """Every member's results in each exchange group it belongs to;
    ``inputs[(E, case)]`` is ``_inputs(E, case)``."""
    import torch.distributed as dist

    out = {}
    for E in SIZES:
        ranks = list(range(E))
        pg = dist.new_group(ranks)  # collective: every rank creates it
        if info.rank >= E:
            continue
        ex = Exchange(group=pg, ranks=ranks, index=info.rank)
        j = info.rank
        for case, (bits, block, _) in enumerate(CASES):
            leaves, raw = inputs[(E, case)]
            qs = [(torch.from_numpy(q[j]), torch.from_numpy(s[j])) for q, s, _, _ in leaves]
            q2s = [(torch.from_numpy(q2[j]), torch.from_numpy(s2[j]))
                   for _, _, q2, s2 in leaves]
            res = {"raw": RA.ring_allgather(torch.from_numpy(raw[j]), ex).numpy()}
            res["gather"] = [tuple(t.numpy() for t in g) for g in RA.gather_wire(
                [(pt_pack(q, bits), s) for q, s in qs], ex, bits=bits)]
            slots = [shard_slot_wire(q, s, bits=bits, block=block, endpoints=E) for q, s in qs]
            res["scatter"] = [tuple(t.numpy() for t in g)
                              for g in RA.scatter_wire(slots, ex, bits=bits)]
            res["allreduce"] = [a.numpy() for a in RA.ring_allreduce_quantized_many(
                qs, ex, bits=bits, block=block)]
            res["reduce_scatter"] = [a.numpy() for a in RA.reduce_scatter_qs_many(
                qs, ex, bits=bits, block=block)]
            res["allgather"] = [a.numpy() for a in RA.allgather_qs_many(
                q2s, ex, bits=bits, block=block)]
            # the one-leaf entry points are the same path
            q, s = qs[0]
            res["allreduce_one"] = RA.ring_allreduce_quantized(q, s, ex, bits=bits,
                                                                block=block).numpy()
            res["reduce_scatter_one"] = RA.reduce_scatter_qs(q, s, ex, bits=bits,
                                                             block=block).numpy()
            res["allgather_one"] = RA.allgather_qs(*q2s[0], ex, bits=bits, block=block).numpy()
            out[(E, case)] = res
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = {(E, c): _inputs(E, c) for E in SIZES for c in range(len(CASES))}
    return LT.spawn(worker, (inputs,), nproc=4, device="cpu", timeout=60,
                    workdir=str(tmp_path_factory.mktemp("ring")))


@functools.lru_cache(maxsize=None)
def _reference(E, case):
    """Per leaf, the reference's results on every endpoint, from one jitted
    ``vmap`` over the exchange axis: the gathered (wire, scales), the
    scattered (wire, scales), and the three quantized collectives."""
    bits, block, _ = CASES[case]
    kw = dict(axis_names=("x",), axis_sizes={"x": E}, bits=bits, block=block,
              transport="ring")

    def one(q, s, q2, s2):
        w = JR.pack_wire(q, bits)
        gathered = JRA.ring_gather_wire(w, s, ("x",), {"x": E})
        ws, ss = JR.shard_slot_wire(q, s, bits=bits, block=block, endpoints=E)
        scattered = JRA.ring_scatter_wire(ws, ss, ("x",), {"x": E})
        return (gathered, scattered, JRA.ring_allreduce_quantized(q, s, **kw),
                JRA.reduce_scatter_qs(q, s, **kw), JRA.allgather_qs(q2, s2, **kw))

    f = jax.jit(jax.vmap(one, axis_name="x"))
    leaves, _ = _inputs(E, case)
    return [jax.tree.map(np.asarray, f(*map(jnp.asarray, leaf))) for leaf in leaves]


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype != b.dtype and {a.dtype, b.dtype} <= {np.dtype(np.int8), np.dtype(np.uint8)}:
        a, b = a.view(np.uint8), b.view(np.uint8)  # wire bytes: int8 or packed uint8
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


IDS = [f"E{E}-case{c}" for E in SIZES for c in range(len(CASES))]
PARAMS = [(E, c) for E in SIZES for c in range(len(CASES))]


@pytest.mark.parametrize("E,case", PARAMS, ids=IDS)
def test_plain_allgather_equals_reference_ring(world, E, case):
    """The plain all-gather gives every member each source's packed wire and
    scales in canonical slots, byte for byte what ``ring_gather_wire``
    gives; and every member's byte buffer (1 to 27 bytes) in its slot."""
    _, raw = _inputs(E, case)
    for i, ref in enumerate(_reference(E, case)):
        wg, sg = ref[0]
        for j in range(E):
            got_w, got_s = world[j][(E, case)]["gather"][i]
            _eq(got_w, wg[j])
            _eq(got_s, sg[j])
    for j in range(E):
        _eq(world[j][(E, case)]["raw"], raw)


@pytest.mark.parametrize("E,case", PARAMS, ids=IDS)
def test_plain_scatter_equals_reference_ring(world, E, case):
    """The plain shard scatter gives member e slot e of every source, in
    canonical source order, byte for byte what the reference's stride-k
    ``_ring_scatter`` (through ``ring_scatter_wire``) gives."""
    for i, ref in enumerate(_reference(E, case)):
        wg, sg = ref[1]
        for j in range(E):
            got_w, got_s = world[j][(E, case)]["scatter"][i]
            _eq(got_w, wg[j])
            _eq(got_s, sg[j])


@pytest.mark.parametrize("E,case", PARAMS, ids=IDS)
def test_quantized_collectives_equal_reference_bit_for_bit(world, E, case):
    """``ring_allreduce_quantized``, ``reduce_scatter_qs`` and
    ``allgather_qs`` of the port equal the reference's (``ring`` transport)
    bit for bit on every member, leaf by leaf when several leaves share a
    launch, and the one-leaf entry points equal the first leaf."""
    for i, ref in enumerate(_reference(E, case)):
        _, _, ar, rs, ag = ref
        for j in range(E):
            res = world[j][(E, case)]
            _eq(res["allreduce"][i], ar[j])
            _eq(res["reduce_scatter"][i], rs[j])
            _eq(res["allgather"][i], ag[j])
            if i == 0:
                _eq(res["allreduce_one"], ar[j])
                _eq(res["reduce_scatter_one"], rs[j])
                _eq(res["allgather_one"], ag[j])


def test_transport_follows_the_device():
    assert RA.resolve_transport("cpu") == "plain"
    assert RA.resolve_transport("cuda") == "cuda-ipc"
    with pytest.raises(ValueError):
        RA.resolve_transport("meta")


@pytest.mark.parametrize("module", ["kernels.ring_allreduce", "kernels.ops", "kernels.wire",
                                    "launch.train"])
def test_module_imports_first(module):
    """Each module of the wire exchange imports first in a fresh
    interpreter (ring_allreduce, wire and ops import one another)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    subprocess.run([sys.executable, "-c", f"import repro_torch.{module}"], check=True,
                   env=env, timeout=120)


def test_layout_packs_at_aligned_offsets():
    """Several leaves in one buffer: every piece starts 16-byte aligned and
    unpacks to the bytes that went in."""
    rng = np.random.default_rng(0)
    pairs = [(torch.from_numpy(rng.integers(-127, 128, n, dtype=np.int8)),
              torch.from_numpy(rng.standard_normal(nb).astype(np.float32)))
             for n, nb in ((5, 1), (256, 1), (1000, 4))]
    lay = RA.WireLayout([(w.shape[0], s.shape[0]) for w, s in pairs])
    assert all(o % 16 == 0 for pair in lay.offsets for o in pair)
    buf = lay.pack(pairs, torch.zeros(lay.nbytes, dtype=torch.uint8))
    for i, (w, s) in enumerate(pairs):
        gw, gs = lay.unpack(buf, i, 8)
        assert torch.equal(gw, w) and torch.equal(gs, s)


def test_a_cuda_exchange_without_mapped_peers_raises():
    """A CUDA tensor never falls back to the plain version: without the
    exchange's symmetric buffer the wrapper raises (checked before any
    launch, so it shows on a meta tensor here)."""
    ex = Exchange(group=None, ranks=[0, 1], index=0)
    x = torch.empty(16, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="symmetric buffer"):
        RA._check_cuda(x, ex, 32, "ring_allgather")

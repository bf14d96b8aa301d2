"""The RMSNorm forward's register path and the quantize wrapper, on the CPU.

The CUDA kernels (``csrc/rmsnorm.cu``, ``csrc/quantize.cu``) run only on the
card, where ``chip_smoke.py`` holds them against their plain versions and
the register-path forward against the block-a-row kernel bit for bit. Here,
with the kernel library replaced by a recorder or in plain numpy:

- the forward's grid comes from (rows, D) alone, and its route (register
  path or block a row) from the dtype, D and alignment;
- the quantize wrapper launches on the tensor's card and stream;
- the register path's order of adding squares (each vector's in order, an
  xor tree across the lanes for each set of 32 vectors, the sets in order)
  gives the block-a-row kernel's sum bit for bit, and both agree with the
  reference's Pallas kernel in interpret mode;
- ``quantize_blockwise_ref`` is bit for bit the reference's Pallas kernel
  at the quantize kernel's edge shapes (n ending mid-vector, block 96,
  bf16 at block 256).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quantize import quantize_blockwise as jax_quantize  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import quantize as QK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import rmsnorm as RK  # noqa: E402

# chip_smoke.py's bound on an fp32 RMSNorm output: 2e-6 of its largest |value|
RMS_F32_REL = 2e-6


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _build.SIGNATURES:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    streams = []
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: streams.append(device) or 77)
    rec.streams = streams
    return rec


# ===========================================================================
# RMSNorm forward: grid and route
# ===========================================================================


def test_rmsnorm_fwd_grid_depends_on_rows_and_D_only(recorder):
    """A block for every 2048 elements, at most four an SM (528): the
    register path's grid is the same for any dtype and any values."""
    assert RK.fwd_blocks(2048, 2048) == RK.fwd_blocks(32768, 128) == RK.FWD_MAX_BLOCKS == 528
    assert RK.fwd_blocks(512, 2048) == 512
    assert RK.fwd_blocks(64, 128) == RK.fwd_blocks(4, 2048) == 4
    assert RK.fwd_blocks(1, 8) == 1
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for scale_by in (1.0, 100.0):
            x = (torch.from_numpy(rng.standard_normal((1040, 128)).astype(np.float32))
                 * scale_by).to(dt)
            RK._launch_fwd(x, torch.ones(128), 1e-5, want_rstd=scale_by > 1)
    names = {name for name, _ in recorder.calls}
    assert names == {"rmsnorm_fwd_launch"}
    # x scale out rstd (4), dtype, rows, D, eps, then nblocks, the card, the stream
    got = {(a[5], a[6], a[8]) for _, a in recorder.calls}
    assert got == {(1040, 128, RK.fwd_blocks(1040, 128))} == {(1040, 128, 65)}
    assert all(len(a) == len(_build.SIGNATURES["rmsnorm_fwd_launch"])
               for _, a in recorder.calls)
    assert all(a[-2:] == (0, 77) for _, a in recorder.calls)


@pytest.mark.parametrize("dtype,rows,D,unaligned,register", [
    ("bfloat16", 1024, 2048, False, True),  # Qwen3's block norm: 256 vectors
    ("bfloat16", 512, 2048, False, False),  # a prefill's: too few wide rows
    ("bfloat16", 4, 2048, False, False),    # a decode step's
    ("bfloat16", 5, 128, False, True),      # the qk-norm: 16 vectors
    ("bfloat16", 1024, 1600, False, True),  # 200 vectors: ragged sets of 32
    ("bfloat16", 5, 40, False, True),       # 5 vectors
    ("bfloat16", 5, 256, False, True),      # 32 vectors: a warp, any rows
    ("bfloat16", 1023, 264, False, False),  # 33 vectors, 1023 rows
    ("bfloat16", 1024, 2056, False, False),  # 257 vectors
    ("bfloat16", 5, 41, False, False),      # not whole vectors
    ("bfloat16", 1024, 2048, True, False),  # an unaligned view
    ("float32", 1024, 1024, False, True),   # 256 vectors of 4
    ("float32", 1024, 1000, False, True),   # 250 vectors
    ("float32", 1024, 2048, False, False),  # 512 vectors
    ("float32", 5, 41, False, False),
    ("float32", 5, 128, True, False),
])
def test_rmsnorm_fwd_route_follows_dtype_D_and_alignment(recorder, dtype, rows, D, unaligned,
                                                          register):
    """Aligned rows of at most 256 vectors of 16 bytes (of more than 32
    only from 1024 rows up) launch the register path's entry point, any
    other the block-a-row one, each with its signature row's argument
    count, the card and the stream; both count one launch."""
    dt = getattr(torch, dtype)
    x = torch.zeros(rows * D + 1, dtype=dt)
    x = (x[1:] if unaligned else x[:-1]).view(rows, D)
    assert RK.fwd_register_path(x) is register
    scale = torch.ones(D)
    before = RK.launches
    out, rstd = RK._launch_fwd(x, scale, 1e-6, want_rstd=True)
    assert RK.launches == before + 1
    assert out.shape == x.shape and out.dtype == dt and rstd.shape == (rows,)
    ((name, args),) = recorder.calls
    assert name == ("rmsnorm_fwd_launch" if register else "rmsnorm_fwd_rowblock_launch")
    assert len(args) == len(_build.SIGNATURES[name])
    assert args[:4] == (x.data_ptr(), scale.data_ptr(), out.data_ptr(), rstd.data_ptr())
    assert list(args[4:7]) == [_build.DTYPE_CODES[dt], rows, D]
    assert args[7] == pytest.approx(1e-6)
    if register:
        assert args[8] == RK.fwd_blocks(rows, D)
    assert args[-2:] == (0, 77) and recorder.streams == [x.device]


# ===========================================================================
# RMSNorm forward: the order of the sum of squares
# ===========================================================================


def _vector_sums(row, vec):
    """Each 16-byte vector's squares added in k order from 0, in fp32 (the
    same code in both kernels)."""
    f = row.reshape(-1, vec).astype(np.float32)
    acc = np.zeros(f.shape[0], np.float32)
    for k in range(vec):
        acc = (acc + f[:, k] * f[:, k]).astype(np.float32)
    return acc


def _xor_tree(vals):
    """Every lane's value after the xor butterfly over len(vals) lanes."""
    v = np.asarray(vals, np.float32)
    lanes = np.arange(v.size)
    o = v.size // 2
    while o:
        v = (v + v[lanes ^ o]).astype(np.float32)
        o //= 2
    assert np.all(v.view(np.uint32) == v[0].view(np.uint32))  # every lane agrees
    return v[0]


def _ss_block_a_row(row, vec):
    """rmsnorm_fwd_kernel: a thread a vector. At most 32 vectors: a slice of
    the next power of two of lanes, one xor tree. More: a block of whole
    warps, a tree a warp, the warps' sums added in order from 0."""
    sums = _vector_sums(row, vec)
    nvec = sums.size
    if nvec <= 32:
        g = 1
        while g < nvec:
            g *= 2
        return _xor_tree(np.pad(sums, (0, g - nvec)))
    threads = -(-nvec // 32) * 32
    lanes = np.pad(sums, (0, threads - nvec))
    t = np.float32(0)
    for w in range(threads // 32):
        t = np.float32(t + _xor_tree(lanes[32 * w:32 * w + 32]))
    return t


def _ss_register_path(row, vec):
    """rmsnorm_fwd_rows_kernel: lane `sub` of lpr lanes holds vectors sub,
    sub + lpr, ... (VPL of them, a power of two); one xor tree for each of
    the VPL slots, then the slots added in order from 0."""
    sums = _vector_sums(row, vec)
    nvec = sums.size
    assert nvec <= RK.FWD_MAX_VECS
    lpr = 1
    while lpr < nvec and lpr < 32:
        lpr *= 2
    vpl = 1
    while vpl * 32 < nvec:
        vpl *= 2
    ss = np.float32(0)
    for i in range(vpl):
        slot = [sums[sub + i * lpr] if sub + i * lpr < nvec else np.float32(0)
                for sub in range(lpr)]
        ss = np.float32(ss + _xor_tree(slot))
    return ss


def _norm(x, s, ss_of, vec, eps):
    D = x.shape[-1]
    out = np.empty_like(x)
    for i, row in enumerate(x):
        ss = ss_of(row, vec)
        r = np.float32(1.0 / np.sqrt(np.float64(np.float32(np.float32(ss / np.float32(D))
                                                             + np.float32(eps)))))
        out[i] = ((row * r).astype(np.float32) * s).astype(np.float32)
    return out


@pytest.mark.parametrize("D,vec", [
    (2048, 8),   # Qwen3's block norm in bf16: 256 vectors, 8 sets of 32
    (1600, 8),   # 200 vectors: the last set ragged
    (1000, 4),   # fp32, 250 vectors
    (1024, 4),   # fp32, 256 vectors
    (96, 4),     # 24 vectors: a slice of 32 lanes
    (128, 8),    # the qk-norm in bf16: a slice of 16 lanes
    (40, 8),     # 5 vectors: a slice of 8 lanes
])
def test_rmsnorm_fwd_register_order_is_block_a_row_order(D, vec):
    """The register path's sum of squares is the block-a-row kernel's to
    the bit in fp32, for every row; both outputs agree with the reference's
    Pallas kernel in interpret mode within chip_smoke.py's fp32 bound."""
    rng = np.random.default_rng(D + vec)
    x = (rng.standard_normal((6, D)) * 2 + 0.5).astype(np.float32)
    x[0] *= 1e3  # rows of other magnitudes
    x[1] *= 1e-3
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    for row in x:
        a, b = _ss_register_path(row, vec), _ss_block_a_row(row, vec)
        assert np.float32(a).view(np.uint32) == np.float32(b).view(np.uint32)
    eps = 1e-6
    reg = _norm(x, s, _ss_register_path, vec, eps)
    blk = _norm(x, s, _ss_block_a_row, vec, eps)
    np.testing.assert_array_equal(reg.view(np.uint32), blk.view(np.uint32))
    ref = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=eps, block_rows=2,
                                 interpret=True))
    for got in (reg, blk):
        rel = np.abs(got - ref).max(-1) / np.abs(ref).max(-1)  # row by row
        assert rel.max() <= RMS_F32_REL


# ===========================================================================
# quantize: the wrapper's launch, and the plain version at the edge shapes
# ===========================================================================


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_wrapper_passes_the_card_and_stream(recorder, dtype):
    """The launch carries x, its dtype code, n, the padded payload and its
    scales, the block geometry, qmax and its fp32 reciprocal, then the
    card's index and the stream of x's device; it counts one launch."""
    dt = getattr(torch, dtype)
    n, block = 64 * 10 + 3, 64
    x = torch.zeros(n, dtype=dt)
    before = QK.launches
    q, s = QK._launch(x, 8, block)
    assert QK.launches == before + 1
    assert q.shape == (11 * block,) and q.dtype == torch.int8 and s.shape == (11,)
    ((name, args),) = recorder.calls
    assert name == "quantize_blockwise_launch"
    assert len(args) == len(_build.SIGNATURES[name])
    assert args[:7] == (x.data_ptr(), _build.DTYPE_CODES[dt], n, q.data_ptr(), s.data_ptr(),
                        11, block)
    assert args[7] == 127.0 and args[8] == float(np.float32(1 / 127))
    assert args[-2:] == (0, 77) and recorder.streams == [x.device]


def _bf16_np(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n,block,dtype", [
    (64 * 100 + 3, 64, "bfloat16"),    # n ends mid-vector (8 bf16 a vector)
    (128 * 50 + 13, 128, "bfloat16"),
    (256 * 30 + 5, 256, "bfloat16"),
    (64 * 100 + 2, 64, "float32"),     # mid-vector (4 fp32 a vector)
    (256 * 40 + 6, 256, "float32"),
    (96 * 200 + 7, 96, "bfloat16"),    # block 96: the scalar kernel's
    (256 * 40, 256, "bfloat16"),       # bf16 at block 256
])
def test_quantize_plain_bitwise_vs_pallas_at_edge_shapes(n, block, dtype):
    """The plain version, which the kernel must equal bit for bit on the
    card, against the reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n + block)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x[:block] = 0.0  # a whole zero block: scale 0, values 0
    if dtype == "bfloat16":
        x = _bf16_np(x)
        qj, sj = jax_quantize(jnp.asarray(x, jnp.bfloat16), bits=8, block=block,
                              interpret=True)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        qj, sj = jax_quantize(jnp.asarray(x), bits=8, block=block, interpret=True)
        xt = torch.from_numpy(x)
    qt, st = R.quantize_blockwise_ref(xt, bits=8, block=block)
    assert qt.shape == (-(-n // block) * block,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))

"""The dense serve path (decode state, prefill, decode step) against the
reference on the CPU.

Teacher-forced rollouts through the port's ``registry.prefill`` and
``decode_step`` are held against the reference's and against the port's
own full forward at each position: RecurrentGemma-9B's reduced config with
a prompt longer than its window of 64 (the local-attention ring wraps),
xLSTM-1.3B's at a chunkwise and a parallel prompt, and Qwen3-1.7B's, where
the dense path must also agree with the paged one. The caches after the
ring wraps, the cache viewed as a pool through the paged decode kernel's
plain version against the reference's ``gqa_attention``, ``generate``'s
greedy tokens against the reference's dense ``generate``, and the dense
path's refusals of the paged path's options. fp32 on both sides; logits
within 1e-4 of the reference's largest (the bound of the reference's own
``test_dense_decode_parity_fallback_archs``), cache tensors within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.config import ParallelConfig  # noqa: E402
from repro.launch import mesh as M  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_steps, build_serve_steps  # noqa: E402
from repro_torch.serve import PagedCacheConfig, generate  # noqa: E402

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_x", "w_y")


def _jcfg(arch, **kw):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0, gain=1.0):
    """Reference parameters as numpy, the matmul weights times ``gain``."""
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x, np.float32) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rollouts(jcfg, tree, toks, S, max_len):
    """Teacher-forced: prefill of toks[:, :S], then a decode step for each
    later token. Returns the reference's and the port's logits (B, D + 1,
    V) (the prefill's last position first), their final states and the
    port's full-forward logits at the same positions."""
    cfg = _port_cfg(jcfg)
    D = toks.shape[1] - S
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jst = jax.jit(lambda p, t: JR.prefill(p, jcfg, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(toks[:, :S]))
    jstep = jax.jit(lambda p, s, t: JR.decode_step(p, jcfg, s, t))
    ref = [np.asarray(jl[:, -1])]
    for t in range(D):
        jl, jst = jstep(jparams, jst, jnp.asarray(toks[:, S + t:S + t + 1]))
        ref.append(np.asarray(jl[:, 0]))
    params = params_from_jax(tree, cfg, device="cpu")
    pt = torch.from_numpy(toks)
    with torch.no_grad():
        pl, pst = PR.prefill(params, cfg, {"tokens": pt[:, :S]}, max_len=max_len)
        got = [pl[:, -1].numpy()]
        for t in range(D):
            pl, pst = PR.decode_step(params, cfg, pst, pt[:, S + t:S + t + 1])
            got.append(pl[:, 0].numpy())
        full, _ = PR.forward(params, cfg, {"tokens": pt})
    return (np.stack(ref, 1), np.stack(got, 1), jst, pst,
            full[:, S - 1:].numpy())


ROLLOUTS = [pytest.param("recurrentgemma-9b", 70, 10, id="recurrentgemma-ring-wraps"),
            pytest.param("xlstm-1.3b", 32, 6, id="xlstm-chunkwise-prompt"),
            pytest.param("xlstm-1.3b", 20, 6, id="xlstm-parallel-prompt"),
            pytest.param("qwen3-1.7b", 12, 6, id="qwen3")]


@pytest.mark.parametrize("arch,S,D", ROLLOUTS)
def test_teacher_forced_rollout_matches_reference_and_full_forward(arch, S, D):
    jcfg = _jcfg(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, S + D)).astype(np.int32)
    ref, got, _, pst, full = _rollouts(jcfg, _tree(jcfg), toks, S, S + D + 1)
    assert got.shape == ref.shape == (2, D + 1, jcfg.vocab_size)
    assert np.isfinite(got).all()
    assert _rel_err(got, ref) <= LOGIT_TOL
    assert _rel_err(got, full) <= LOGIT_TOL
    assert pst["position"] == S + D


def test_dense_path_agrees_with_paged_path():
    """Qwen3-1.7B reduced: the dense rollout's logits equal the paged
    engine steps' on the same tokens, within 1e-4."""
    jcfg = _jcfg("qwen3-1.7b")
    cfg = _port_cfg(jcfg)
    params = params_from_jax(_tree(jcfg), cfg, device="cpu")
    S, D, bs = 12, 6, 4
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, S + D)).astype(np.int32))
    pcfg = PagedCacheConfig(num_blocks=8, block_size=bs, dtype="float32")
    paged = build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu")
    pools = paged.init_pools()
    table = torch.arange(1, 7, dtype=torch.int32)
    lg, pools = paged.prefill_step(params, toks[:, :S], pools, table[:S // bs], S - 1)
    want = [lg[0]]
    for t in range(D):
        pos = torch.tensor([S + t], dtype=torch.int32)
        lg, pools = paged.decode_step(params, pools, toks[:, S + t], pos, table[None], pos + 1)
        want.append(lg[0])
    dense = build_serve_steps(cfg, batch=1, max_len=S + D, device="cpu")
    lg, state = dense.prefill_step(params, {"tokens": toks[:, :S]})
    assert lg.shape == (1, 1, cfg.vocab_size)
    got = [lg[0, 0]]
    for t in range(D):
        lg, state = dense.serve_step(params, state, toks[:, S + t:S + t + 1])
        got.append(lg[0, 0])
    assert _rel_err(torch.stack(got).numpy(), torch.stack(want).numpy()) <= LOGIT_TOL


def test_ring_cache_after_wrapping_matches_reference():
    """RecurrentGemma's local-attention cache (ring of 64) after a prompt
    of 70 and 10 decode steps: ``pos`` and ``length`` exact, k and v within
    1e-5; the RG-LRU states within 1e-5 too."""
    jcfg = _jcfg("recurrentgemma-9b")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 80)).astype(np.int32)
    _, _, jst, pst, _ = _rollouts(jcfg, _tree(jcfg), toks, 70, 81)
    for i in range(jcfg.num_layers):
        jl, pl = jst["layers"][i], pst["layers"][i]
        if jcfg.block_kind(i) == "local_attn":
            assert pl["k"].shape == tuple(jl["k"].shape) == (2, 64, 1, 64)
            assert pl["length"] == int(jl["length"]) == 80
            assert np.array_equal(pl["pos"].numpy(), np.asarray(jl["pos"]))
            assert sorted(pl["pos"][0].tolist()) == list(range(16, 80))
            for key in ("k", "v"):
                assert _rel_err(pl[key].numpy(), jl[key]) <= CACHE_TOL
        else:
            for key in ("hidden", "conv"):
                assert _rel_err(pl[key].numpy(), jl[key]) <= CACHE_TOL


def test_linear_cache_is_rounded_up_and_matches_reference():
    """A full-attention layer's linear buffer: the port's is rounded up to
    a multiple of the pool view's block; its first slots are the
    reference's, the rest unwritten (pos -1)."""
    jcfg = _jcfg("qwen3-1.7b")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 15)).astype(np.int32)
    _, _, jst, pst, _ = _rollouts(jcfg, _tree(jcfg), toks, 12, 18)
    jl, pl = jst["layers"][0], pst["layers"][0]
    n = jl["k"].shape[1]
    assert (n, pl["k"].shape[1]) == (18, 32) and pl["length"] == int(jl["length"]) == 15
    assert np.array_equal(pl["pos"][:, :n].numpy(), np.asarray(jl["pos"]))
    assert (pl["pos"][:, n:] == -1).all()
    for key in ("k", "v"):
        assert _rel_err(pl[key][:, :n].numpy(), jl[key]) <= CACHE_TOL


# (length before the step, window, slots): a ring that has wrapped, one
# that has not, and a linear buffer
VIEW_CASES = [pytest.param(100, 64, 64, id="ring-wrapped"),
              pytest.param(30, 64, 64, id="ring-filling"),
              pytest.param(63, 64, 64, id="ring-fills-now"),
              pytest.param(30, 0, 48, id="linear")]


@pytest.mark.parametrize("length,window,size", VIEW_CASES)
def test_cache_as_pool_view_matches_reference_attention(length, window, size):
    """The decode step's attention: the new token's k / v written at its
    slot, then the cache viewed as a pool through the paged decode kernel's
    plain version, against the reference's ``gqa_attention`` with its
    positional masks over the same cache (MQA 4:1, hd 32)."""
    cfg = pt_config.ModelConfig(num_heads=4, num_kv_heads=1, d_model=128, dtype="float32",
                                positional="none")
    rng = np.random.default_rng(length + window)
    B, H, Hkv, hd = 3, 4, 1, 32
    k_c, v_c = (rng.standard_normal((B, size, Hkv, hd)).astype(np.float32) for _ in range(2))
    pos = np.full((B, size), -1, np.int32)
    for p in range(max(0, length - size), length):  # the slots written so far
        pos[:, p % size if window else p] = p
    q, k, v = (rng.standard_normal((B, 1, n, hd)).astype(np.float32) for n in (H, Hkv, Hkv))
    cache = {"k": torch.from_numpy(k_c.copy()), "v": torch.from_numpy(v_c.copy()),
             "pos": torch.from_numpy(pos.copy()), "length": length}
    out, new = PA._decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), cache, cfg, window=window)
    slot = length % size if window else length
    k_c[:, slot], v_c[:, slot], pos[:, slot] = k[:, 0], v[:, 0], length
    ref = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k_c), jnp.asarray(v_c),
                           q_positions=jnp.asarray([length], jnp.int32),
                           kv_positions=jnp.asarray(pos), causal=True, window=window)
    assert _rel_err(out.numpy(), ref) <= CACHE_TOL
    assert new["length"] == length + 1
    assert np.array_equal(new["pos"].numpy(), pos)
    assert np.array_equal(new["k"].numpy(), k_c)


def test_cache_sizes_and_unviewable_ring():
    assert [PA.cache_size(n, w) for n, w in ((81, 64), (60, 64), (18, 0), (16, 0))] == [
        64, 64, 32, 16]
    with pytest.raises(ValueError, match="cannot be viewed"):
        PA.cache_size(100, 40)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_generate_greedy_matches_reference_dense_generate(arch):
    """``generate`` takes the dense path, and its greedy tokens are the
    reference's dense ``generate``'s (as tests/test_serving.py runs it)."""
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=1, gain=4.0)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    want, jinfo = jax_generate(jax.tree.map(jnp.asarray, tree), jcfg, pc, mesh, prompts, 8)
    got, info = generate(params_from_jax(tree, cfg, device="cpu"), cfg, prompts, 8)
    assert jinfo["path"] == info["path"] == "dense"
    assert got.dtype == np.int32 and got.shape == (2, 8)
    assert len(info["token_times"]) == 9 and info["token_times"] == sorted(info["token_times"])
    assert got.tolist() == np.asarray(want).tolist()
    assert len(set(got[0].tolist())) > 1  # the tokens move


def test_dense_path_refuses_the_paged_paths_options(tmp_path):
    """``on_step`` and a paged-cache config in ``generate``, and
    ``--ckpt-dir`` and ``--int8-kv`` in the launcher, raise on the dense
    path instead of being ignored; the launcher serves it and says so."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as launch_serve

    cfg = get_reduced_config("xlstm-1.3b")
    params = PR.init_params(cfg, seed=0, device="cpu")
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="dense path"):
        generate(params, cfg, prompts, 2, on_step=lambda eng: None)
    with pytest.raises(ValueError, match="dense path"):
        generate(params, cfg, prompts, 2, pcfg=PagedCacheConfig())
    base = ["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu", "--tokens", "3",
            "--batch", "2", "--prompt-len", "5"]
    for extra in (["--ckpt-dir", str(tmp_path)], ["--int8-kv"]):
        with pytest.raises(ValueError, match="dense path"):
            launch_serve.main(base + extra)
    out, info = launch_serve.main(base)
    assert info["path"] == "dense" and out.shape == (2, 3)

"""The PyTorch port's serving path against the reference's, on the CPU.

Teacher-forced paged rollouts (bf16/fp32 and int8 pools), the
continuous-batching engine on a mixed-length trace, the block allocator's
invariants, the launcher, and the rule that a ``cuda`` request without a
GPU raises. The reference's parameters are carried into the port with
``params_from_jax``; inputs are made with numpy from a seed and handed to
both packages. On the CPU the port's wrappers run the plain versions of
their kernels.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hyp import given, settings, st  # noqa: E402

from repro.config import ParallelConfig  # noqa: E402
from repro.configs import get_reduced_config  # noqa: E402
from repro.launch import mesh as M  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.parallel.steps import build_paged_serve_steps as jax_build_steps  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve import paged_model as JPM  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import decode_attention as DK  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import quantize as QK  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_steps  # noqa: E402
from repro_torch.serve import (BlockAllocator, EngineConfig, PagedCacheConfig,  # noqa: E402
                               ServeEngine, generate, kv_cache as KC)


def _jax_cfg(num_kv_heads=4):
    return dataclasses.replace(get_reduced_config("gpt2-xl"), dtype="float32",
                               param_dtype="float32", num_kv_heads=num_kv_heads)


def _both_params(jcfg, seed=0):
    """(reference params, port config, port params on the CPU)."""
    jparams = JR.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jparams, cfg, params


def _launches():
    return (FK.launches, DK.launches, QK.launches)


# ===========================================================================
# teacher-forced paged rollouts: port vs reference
# ===========================================================================


def _jax_rollout(cfg, params, toks, S, D, pcfg):
    """The reference's teacher-forced paged prefill + D decode steps."""
    pools = JKC.init_pools(cfg, pcfg)
    bs = pcfg.block_size
    pad = (-S) % bs
    n_blocks = pcfg.blocks_for(S + pad + D)
    table = np.arange(1, 1 + n_blocks, dtype=np.int32)
    prompt = np.zeros((1, S + pad), np.int32)
    prompt[0, :S] = toks[:S]
    lg, pools = JPM.paged_prefill(params, cfg, jnp.asarray(prompt), pools,
                                  jnp.asarray(table[: (S + pad) // bs]), pcfg=pcfg)
    out = [np.asarray(lg[0, S - 1], np.float32)]
    for t in range(D):
        pos = S + t
        lg, pools = JPM.paged_decode_step(
            params, cfg, pools, jnp.asarray(toks[pos:pos + 1]),
            jnp.array([pos], jnp.int32), jnp.asarray(table[None]),
            jnp.array([pos + 1], jnp.int32), pcfg=pcfg)
        out.append(np.asarray(lg[0], np.float32))
    return np.stack(out)


def _port_rollout(cfg, params, toks, S, D, pcfg):
    """The same rollout through the port's serve steps, on the CPU."""
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu")
    pools = bundle.init_pools()
    bs = pcfg.block_size
    pad = (-S) % bs
    n_blocks = pcfg.blocks_for(S + pad + D)
    table = torch.arange(1, 1 + n_blocks, dtype=torch.int32)
    prompt = torch.zeros((1, S + pad), dtype=torch.int32)
    prompt[0, :S] = torch.from_numpy(toks[:S])
    lg, pools = bundle.prefill_step(params, prompt, pools, table[: (S + pad) // bs], S - 1)
    out = [lg[0].numpy()]
    for t in range(D):
        pos = S + t
        lg, pools = bundle.decode_step(
            params, pools, torch.from_numpy(toks[pos:pos + 1]),
            torch.tensor([pos], dtype=torch.int32), table[None],
            torch.tensor([pos + 1], dtype=torch.int32))
        out.append(lg[0].numpy())
    return np.stack(out)


@pytest.mark.parametrize("num_kv_heads", [4, 2])  # MHA, GQA 2:1
def test_paged_rollout_matches_reference(num_kv_heads):
    jcfg = _jax_cfg(num_kv_heads)
    jparams, cfg, params = _both_params(jcfg)
    S, D = 21, 6
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, S + D).astype(np.int32)
    jpcfg = JKC.PagedCacheConfig(num_blocks=10, block_size=8, dtype="float32")
    pcfg = PagedCacheConfig(num_blocks=10, block_size=8, dtype="float32")
    ref = _jax_rollout(jcfg, jparams, toks, S, D, jpcfg)
    before = _launches()
    out = _port_rollout(cfg, params, toks, S, D, pcfg)
    assert _launches() == before  # the CPU path never launches a kernel
    assert out.shape == (D + 1, cfg.vocab_size) and out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-5
    # and the port's own full forward agrees with its paged rollout
    full, _ = PR.forward(params, cfg, {"tokens": torch.from_numpy(toks[None, :S + D])})
    assert np.abs(out - full[0, S - 1:S + D].numpy()).max() <= 1e-5


def test_int8_paged_rollout_matches_reference():
    jcfg = _jax_cfg(2)
    jparams, cfg, params = _both_params(jcfg, seed=1)
    S, D = 13, 5
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, S + D).astype(np.int32)
    ref = _jax_rollout(jcfg, jparams, toks, S, D,
                       JKC.PagedCacheConfig(num_blocks=8, block_size=4, quantized=True))
    out = _port_rollout(cfg, params, toks, S, D,
                        PagedCacheConfig(num_blocks=8, block_size=4, quantized=True))
    assert np.abs(out - ref).max() <= 1e-3
    # the reference's own int8 tolerance against the unquantized rollout
    fp = _port_rollout(cfg, params, toks, S, D,
                       PagedCacheConfig(num_blocks=8, block_size=4, dtype="float32"))
    assert np.abs(out - fp).max() <= 0.02 * np.abs(fp).max()


def test_pool_writes_are_in_place_and_match_reference_layout():
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg(2)))
    for quantized in (False, True):
        pcfg = PagedCacheConfig(num_blocks=4, block_size=4, quantized=quantized)
        pools = KC.init_pools(cfg, pcfg, "cpu")
        ptrs = {k: v.data_ptr() for k, v in pools.items()}
        hd = cfg.resolved_head_dim
        assert pools["k"].shape == (cfg.num_layers, 4, 4, cfg.num_kv_heads, hd)
        assert KC.pool_nbytes(cfg, pcfg) == sum(v.nbytes for v in pools.values())
        k = torch.randn(8, cfg.num_kv_heads, hd, generator=torch.Generator().manual_seed(0))
        out = KC.write_prefill(pools, 1, torch.tensor([3, 1], dtype=torch.int32),
                               k, -k, pcfg=pcfg)
        out = KC.write_token(out, 0, torch.tensor([2, 0], dtype=torch.int32),
                             torch.tensor([1, 3], dtype=torch.int32), k[:2], k[:2],
                             pcfg=pcfg)
        assert {n: v.data_ptr() for n, v in out.items()} == ptrs
        got = out["k"][1, 3].float()
        if quantized:
            got = got * out["k_scale"][1, 3][..., None]
        assert torch.allclose(got, k[:4], atol=0.02)
        assert out["k"][0, 2, 1].abs().sum() > 0 and out["k"][0, 1].abs().sum() == 0


# ===========================================================================
# block allocator invariants (ported from the reference's property tests)
# ===========================================================================


@given(num_blocks=st.integers(2, 64), seed=st.integers(0, 2**16))
@settings(max_examples=20, deadline=None)
def test_allocator_invariants(num_blocks, seed):
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(num_blocks)
    usable = num_blocks - 1
    live = []
    for _ in range(200):
        if live and (rng.random() < 0.4 or alloc.num_free == 0):
            blk = live.pop(int(rng.integers(len(live))))
            alloc.free(blk)
        elif alloc.num_free > 0:
            blk = alloc.alloc()
            assert blk != KC.SINK_BLOCK  # the sink never circulates
            assert 0 < blk < num_blocks
            assert blk not in live  # no double allocation
            live.append(blk)
        assert alloc.num_free + len(alloc.allocated) == usable
        assert set(live) == set(alloc.allocated)
    alloc.free_many(live)
    assert alloc.num_free == usable


def test_allocator_errors():
    alloc = BlockAllocator(4)
    blks = alloc.alloc_many(3)
    with pytest.raises(RuntimeError):
        alloc.alloc()  # exhausted
    with pytest.raises(RuntimeError):
        alloc.alloc_many(1)
    alloc.free(blks[0])
    with pytest.raises(ValueError):
        alloc.free(blks[0])  # double free
    with pytest.raises(ValueError):
        alloc.free(KC.SINK_BLOCK)  # the sink is never allocatable
    with pytest.raises(ValueError):
        BlockAllocator(1)
    with pytest.raises(ValueError):
        PagedCacheConfig(num_blocks=1)


# ===========================================================================
# continuous-batching engine: port vs reference on one trace
# ===========================================================================

TRACE_LENS = [3, 9, 5, 12, 2, 7]


def _check_slot_invariants(engine):
    seen = set()
    for s in engine.slots:
        if s is None:
            continue
        assert len(s.blocks) * engine.pcfg.block_size >= s.pos
        assert len(s.blocks) == engine._blocks_needed(s.req)
        for b in s.blocks:
            assert b != KC.SINK_BLOCK and b not in seen
            seen.add(b)
    assert seen == set(engine.alloc.allocated)


@pytest.mark.parametrize("continuous", [True, False])
def test_engine_matches_reference_engine(continuous):
    jcfg = _jax_cfg()
    jparams, cfg, params = _both_params(jcfg)
    ekw = dict(max_slots=3, max_new_tokens=5, max_blocks_per_seq=5, continuous=continuous)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in TRACE_LENS]

    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    jpcfg = JKC.PagedCacheConfig(num_blocks=20, block_size=4, dtype="float32")
    jeng = JServeEngine(jparams, jcfg, jax_build_steps(jcfg, pc, mesh, pcfg=jpcfg),
                        jpcfg, JEngineConfig(**ekw))
    pcfg = PagedCacheConfig(num_blocks=20, block_size=4, dtype="float32")
    eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"),
                      pcfg, EngineConfig(**ekw))
    for p in prompts:
        jeng.submit(p, 5)
        eng.submit(p, 5)
    jres = jeng.run()
    steps = 0
    while eng.step():
        _check_slot_invariants(eng)
        steps += 1
        assert steps < 200
    res = sorted(eng.finished, key=lambda r: r.uid)

    assert [r.prompt_len for r in res] == TRACE_LENS
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert eng.stats == jeng.stats
    assert eng.alloc.num_free == pcfg.num_blocks - 1  # no leak after drain


def test_engine_refuses_a_request_wider_than_its_table():
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg()))
    params = PR.init_params(cfg, seed=0, device="cpu")
    pcfg = PagedCacheConfig(num_blocks=20, block_size=4, dtype="float32")
    eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"),
                      pcfg, EngineConfig(max_slots=2, max_new_tokens=8, max_blocks_per_seq=4))
    eng.submit(np.arange(40) % cfg.vocab_size, 8)  # 12 blocks > width 4
    with pytest.raises(ValueError):
        eng.step()


def test_generate_greedy_and_unported_paths():
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg()))
    params = PR.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6))
    out, info = generate(params, cfg, prompts, 4)
    assert info["path"] == "paged" and out.shape == (2, 4) and out.dtype == np.int32
    # greedy decode = argmax of the full forward, token by token
    seq = torch.from_numpy(np.concatenate([prompts[0], out[0, :3]])[None].astype(np.int32))
    logits, _ = PR.forward(params, cfg, {"tokens": seq})
    assert logits[0, 5:].argmax(-1).tolist() == out[0].tolist()
    # an mLSTM pattern is not paged-supported: it serves through the dense path
    mcfg = cfg.replace(block_pattern=("mlstm",))
    out_m, info_m = generate(PR.init_params(mcfg, seed=0, device="cpu"), mcfg, prompts, 2)
    assert info_m["path"] == "dense" and out_m.shape == (2, 2) and out_m.dtype == np.int32
    # an encoder-decoder initializes now, with its encoder and cross blocks
    ecfg = cfg.replace(is_encoder_decoder=True, encoder_layers=1, encoder_seq_len=8)
    names = [n for n, _ in T.param_leaves(PR.init_params(ecfg, device="cpu"))]
    assert "encoder.layers.0.mix.wq" in names and "encoder.positions" in names
    assert "layers.0.cross.wq" in names and "layers.0.norm_cross.scale" in names
    assert KC.paged_supported(ecfg)[0] is False


# ===========================================================================
# launcher and device selection
# ===========================================================================


@pytest.mark.parametrize("extra", [[], ["--int8-kv", "--sample"]])
def test_launcher_runs_on_the_cpu(extra, capsys):
    out, info = launch_serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                                   "--prompt-len", "5", "--tokens", "3", *extra])
    assert out.shape == (2, 3)
    assert info["engine"].stats["prefills"] == 2
    assert "arch=gpt2-xl-reduced path=paged device=cpu" in capsys.readouterr().out


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--reduced", "--batch", "1", "--tokens", "1"])  # default cuda
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg()))
    with pytest.raises(RuntimeError, match="cuda"):
        PR.init_params(cfg)  # default device
    with pytest.raises(RuntimeError, match="cuda"):
        build_paged_serve_steps(cfg, pcfg=PagedCacheConfig())
    with pytest.raises(ValueError):
        repro_torch.resolve_device("mps")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")

"""DeepSeek-V2-236B and Kimi-K2 (MoE; MLA and GQA) against the reference on
the CPU, at their reduced configs in fp32.

The forward's logits and summed router losses (``moe_aux``, ``moe_z``) and
``loss_fn``'s value (cross-entropy plus ``router_aux_loss_coef * moe_aux +
1e-4 * moe_z``) for both; DeepSeek-V2 through the dense path
(``registry.prefill`` and 8 teacher-forced ``decode_step``s against the
reference's, MLA's latent cache included); Kimi-K2 through the paged path
(``generate``'s greedy tokens against the reference's ``generate`` with
bf16 K/V pools and with int8 blocks, prompts padded to the block size so
the prefill routes pad tokens too); the launcher on both; both accepted for
training (their gradients are held in ``test_torch_moe_train.py``).
Logits within 1e-4 of the reference's largest |value| and losses within
1e-5 relative (the bounds of the other model tests); tokens exactly.
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
from repro.models import registry as JR  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import PagedCacheConfig, generate  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_losses_and_loss_match_reference(arch):
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.where(rng.random((2, 16)) < 0.2, -1, rng.integers(0, jcfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": labels.astype(np.int32)}

    def ref(p, b):
        return JR.forward(p, jcfg, b), JR.loss_fn(p, jcfg, b)

    (jl, jaux), (jtotal, jm) = jax.jit(ref)(jax.tree.map(jnp.asarray, tree),
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = PR.forward(params, cfg, tb)
        total, m = PR.loss_fn(params, cfg, tb)
    assert _rel_err(logits.numpy(), jl) <= LOGIT_TOL
    for got, want in ((aux["moe_aux"], jaux["moe_aux"]), (aux["moe_z"], jaux["moe_z"]),
                      (total, jtotal), (m["lm_loss"], jm["lm_loss"]),
                      (m["moe_aux"], jm["moe_aux"]), (m["moe_z"], jm["moe_z"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
    # one MoE layer: its losses are the sums; the total adds them
    assert float(aux["moe_aux"]) > 0 and float(aux["moe_z"]) > 0
    want = float(m["lm_loss"]) + cfg.router_aux_loss_coef * float(m["moe_aux"]) \
        + 1e-4 * float(m["moe_z"])
    assert abs(float(total) - want) <= 1e-6 * want


def test_deepseek_dense_rollout_matches_reference():
    """A prefill of 12 tokens, then 8 teacher-forced decode steps against
    the absorbed MLA decode's latent cache: every step's logits and the
    final caches against the reference's."""
    jcfg = _jcfg("deepseek-v2-236b")
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=2)
    S, D, max_len = 12, 8, 24
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, S + D)).astype(np.int32)
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
    ref, got = np.stack(ref, 1), np.stack(got, 1)
    assert got.shape == (2, D + 1, jcfg.vocab_size) and np.isfinite(got).all()
    assert _rel_err(got, ref) <= LOGIT_TOL
    assert pst["position"] == S + D
    for layer, jlayer in zip(pst["layers"], jst["layers"]):
        assert set(layer) == {"ckv", "krope", "pos", "length"}
        assert layer["length"] == int(jlayer["length"]) == S + D
        assert np.array_equal(layer["pos"].numpy(), np.asarray(jlayer["pos"]))
        for k in ("ckv", "krope"):
            assert _rel_err(layer[k].numpy(), jlayer[k]) <= LOGIT_TOL


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_kimi_paged_generate_matches_reference(kv):
    """Three prompts of 10 tokens (padded to 12 in blocks of 4) and 6 new
    tokens each through both packages' ``generate`` (the paged engine, 3
    slots): the same greedy tokens."""
    jcfg = _jcfg("kimi-k2-1t-a32b")
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=4, gain=4.0)
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    pkw = dict(quantized=True) if kv == "int8" else dict(dtype="bfloat16")
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    jout, jinfo = jax_generate(jax.tree.map(jnp.asarray, tree), jcfg, pc, mesh, prompts, 6,
                               pcfg=JKC.PagedCacheConfig(num_blocks=16, block_size=4, **pkw))
    out, info = generate(params_from_jax(tree, cfg, device="cpu"), cfg, prompts, 6,
                         pcfg=PagedCacheConfig(num_blocks=16, block_size=4, **pkw))
    assert jinfo["path"] == info["path"] == "paged"
    assert np.array_equal(out, np.asarray(jout))
    assert len(set(out.ravel().tolist())) > 3  # not one repeated token
    assert info["engine"].stats == jinfo["engine"].stats


@pytest.mark.parametrize("arch,path", [("deepseek-v2-236b", "dense"),
                                       ("kimi-k2-1t-a32b", "paged")])
def test_launcher_serves_the_moe_families_on_the_cpu(arch, path, capsys):
    out, info = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    assert out.shape == (2, 3) and info["path"] == path
    assert f"arch={arch}-reduced path={path} device=cpu" in capsys.readouterr().out
    if path == "dense":
        with pytest.raises(ValueError):  # the paged path's option
            launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--int8-kv"])


@pytest.mark.parametrize("arch", ARCHS)
def test_training_refuses_moe_and_mla(arch):
    """Since MoE and MLA train, the name keeps the case count: both archs
    pass ``check_token_batches`` and build a ``SimulatedRun`` on the CPU,
    in training storage with the experts' and MLA's leaves under AdamW;
    since the recurrent families train too, a model with recurrent blocks
    passes it as well, and only an encoder-decoder is refused (its token
    batches carry no frames)."""
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jax_configs.get_reduced_config(arch)))
    PT.check_ported(cfg)  # it serves
    PT.check_token_batches(cfg, "SimulatedRun", "MarkovLM")  # and trains
    run = SimulatedRun(cfg, TrainConfig(total_steps=4, global_batch_size=2, seq_len=8),
                       num_groups=1, device="cpu")
    leaves = PT.param_leaves(run.state.params)
    names = [n for n, _ in leaves]
    assert "layers.1.mlp.router" in names and "layers.1.mlp.shared.w_up" in names
    assert ("layers.0.mix.kv_norm" in names) == (cfg.attention_kind == "mla")
    assert all(t.dtype == torch.float32 and t.requires_grad for _, t in leaves)
    assert len(run.state.opt.mu) == len(leaves)
    recurrent = pt_config.ModelConfig(**dataclasses.asdict(
        jax_configs.get_reduced_config("xlstm-1.3b")))
    PT.check_token_batches(recurrent, "SimulatedRun", "MarkovLM")
    whisper = pt_config.ModelConfig(**dataclasses.asdict(
        jax_configs.get_reduced_config("whisper-large-v3")))
    with pytest.raises(ValueError, match="carry no \"frames\""):
        PT.check_token_batches(whisper, "SimulatedRun", "MarkovLM")

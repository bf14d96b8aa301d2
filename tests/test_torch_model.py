"""The PyTorch port's model against the reference, plus the port's hygiene.

The reference's parameters are carried into the port with
``repro_torch.convert.params_from_jax``, so both packages compute the same
model on the same numpy inputs; everything runs in fp32 on the CPU, where
the port's attention is the plain version of its flash kernel.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
import repro.configs as jax_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GPT2 = ["gpt2-small", "gpt2-medium", "gpt2-xl", "gpt2-7b"]


def _f32(name, **kw):
    return dataclasses.replace(jax_configs.get_reduced_config(name),
                               dtype="float32", param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _jax_params(cfg, seed=0):
    params = JR.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


# ===========================================================================
# configs: the port's copies equal the originals
# ===========================================================================


def test_model_config_fields_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_config.ModelConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pt_config.ModelConfig)]
    assert pf == jf


@pytest.mark.parametrize("name", GPT2)
def test_gpt2_configs_equal_reference(name):
    for get in ("get_config", "get_reduced_config"):
        jc = getattr(jax_configs, get)(name)
        pc = getattr(pt_configs, get)(name)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc), (name, get)
        assert pc.resolved_head_dim == jc.resolved_head_dim


def test_get_config_refuses_unported_architectures():
    """Every architecture the reference registers is ported (Chameleon-34B
    and Whisper-large-v3 last); an unknown name still raises."""
    ported = set(pt_configs.list_architectures())
    assert ported == set(GPT2) | {"qwen3-1.7b", "minicpm-2b", "granite-8b", "qwen3-14b",
                                  "recurrentgemma-9b", "xlstm-1.3b", "deepseek-v2-236b",
                                  "kimi-k2-1t-a32b", "chameleon-34b", "whisper-large-v3"}
    assert ported == set(jax_configs.list_architectures())
    assert not hasattr(pt_configs, "NOT_PORTED")
    for name in ported:
        assert pt_configs.get_config(name).name == jax_configs.get_config(name).name
    with pytest.raises(KeyError):
        pt_configs.get_config("no-such-model")


# ===========================================================================
# building blocks
# ===========================================================================


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_reference(norm):
    cfg = _f32("gpt2-xl", norm=norm)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    ref = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg)
    out = PL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), _port_cfg(cfg))
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


def test_apply_mlp_matches_reference():
    cfg = _f32("gpt2-xl")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"w_up": (rng.standard_normal((cfg.d_model, cfg.d_ff)) * 0.05).astype(np.float32),
         "w_down": (rng.standard_normal((cfg.d_ff, cfg.d_model)) * 0.05).astype(np.float32)}
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg)
    out = PL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), _port_cfg(cfg))
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


# ===========================================================================
# forward: logits and collected K/V streams
# ===========================================================================


@pytest.mark.parametrize("num_kv_heads", [4, 2])
def test_forward_matches_reference(num_kv_heads):
    jcfg = _f32("gpt2-xl", num_kv_heads=num_kv_heads)
    cfg = _port_cfg(jcfg)
    jparams, tree = _jax_params(jcfg)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)

    ref, jaux = JR.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, collect_kv=True)
    out, aux = PR.forward(params, cfg, {"tokens": torch.from_numpy(toks)}, collect_kv=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5
    for (k, v), (jk, jv) in zip(aux["kv"], jaux["kv"]):
        assert np.abs(k.numpy() - np.asarray(jk)).max() <= 1e-5
        assert np.abs(v.numpy() - np.asarray(jv)).max() <= 1e-5


def test_params_keep_reference_keys_layouts_and_dtypes():
    jcfg = jax_configs.get_reduced_config("gpt2-xl")  # bf16 compute, fp32 params
    cfg = _port_cfg(jcfg)
    _, tree = _jax_params(jcfg)
    params = params_from_jax(tree, cfg, device="cpu")
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    sd = params.state_dict()
    assert set(sd) == {k.replace("/", ".") for k in flat}
    for key, leaf in flat.items():
        t = sd[key.replace("/", ".")]
        assert tuple(t.shape) == leaf.shape, key
        name = key.rsplit("/", 1)[-1]
        want = torch.bfloat16 if name in ("wq", "wk", "wv", "wo", "w_up",
                                          "w_down", "positions") else torch.float32
        assert t.dtype == want and not t.requires_grad, key
        np.testing.assert_array_equal(t.float().numpy(),
                                      torch.tensor(leaf).to(want).float().numpy())
    assert tuple(sd["layers.1.mix.wq"].shape) == (cfg.d_model, cfg.num_heads,
                                                   cfg.resolved_head_dim)
    assert tuple(sd["layers.1.mix.wo"].shape) == (cfg.num_heads, cfg.resolved_head_dim,
                                                   cfg.d_model)


def test_init_params_shapes_and_seed():
    cfg = pt_configs.get_reduced_config("gpt2-xl")
    a = PR.init_params(cfg, seed=3, device="cpu")
    b = PR.init_params(cfg, seed=3, device="cpu")
    c = PR.init_params(cfg, seed=4, device="cpu")
    _, tree = _jax_params(jax_configs.get_reduced_config("gpt2-xl"))
    shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path).replace("/", "."):
              leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    sa = a.state_dict()
    assert {k: tuple(v.shape) for k, v in sa.items()} == shapes
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sa.items())
    assert not torch.equal(sa["embed.tokens"], c.state_dict()["embed.tokens"])
    w = sa["embed.tokens"]
    assert float(w.abs().max()) <= 3 * 0.02 and 0.015 < float(w.std()) < 0.02


# ===========================================================================
# hygiene: the port imports neither JAX nor the reference package
# ===========================================================================


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, repro_torch.launch.serve, "
            "repro_torch.serve, repro_torch.kernels.ops, repro_torch.parallel.steps, "
            "repro_torch.core.simulate, repro_torch.core.outer, repro_torch.core.pier, "
            "repro_torch.optim, repro_torch.sync, repro_torch.data.synthetic, "
            "repro_torch.kernels.pier_update; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

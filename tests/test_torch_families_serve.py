"""Paged serving of MiniCPM-2B, Granite-8B and Qwen3-14B against the
reference's engine on the CPU.

Greedy rollouts through both continuous-batching engines, with bf16 K/V
pools and with int8 blocks, at each family's head layout: MHA with
MiniCPM's odd vocabulary of 122 753 rows (the sampler's argmax over it),
GQA 4:1 with Granite's untied ``lm_head``, and Qwen3-14B's GQA 5:1 at
head_dim 128. Reduced configs in fp32; the weights are the reference's,
carried over with ``params_from_jax``.
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
from repro.parallel.steps import build_paged_serve_steps as jax_build_steps  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_steps  # noqa: E402
from repro_torch.serve import EngineConfig, PagedCacheConfig, ServeEngine  # noqa: E402

MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MINICPM_VOCAB = 122_753


def _jcfg(arch, **kw):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0, gain=4.0):
    """Reference parameters as numpy, the layers' matmul weights times
    ``gain`` (at the init's std a 2-layer model's greedy tokens barely move)."""
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


SERVE_CASES = [
    # MHA at MiniCPM's vocabulary of 122 753 rows (odd: the sampler's argmax
    # and the tied table's last rows)
    pytest.param("minicpm-2b", {"vocab_size": MINICPM_VOCAB}, id="minicpm-2b-mha"),
    pytest.param("granite-8b", {}, id="granite-8b-4to1-untied"),
    # the reduced qwen3-14b config is 8:2 (4:1); the family's 5:1 needs
    # 10 heads over 2
    pytest.param("qwen3-14b", {"num_heads": 10, "num_kv_heads": 2, "head_dim": 128},
                 id="qwen3-14b-5to1-hd128"),
]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch,kw", SERVE_CASES)
def test_paged_rollout_matches_reference_engine(arch, kw, kv):
    """Five prompts of mixed lengths through both continuous-batching
    engines (3 slots, block 4), bf16 K/V pools or int8 blocks (block =
    head_dim): identical greedy tokens and engine stats."""
    jcfg = _jcfg(arch, **kw)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    pkw = dict(quantized=True) if kv == "int8" else dict(dtype="bfloat16")
    ekw = dict(max_slots=3, max_new_tokens=5, max_blocks_per_seq=5)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 9, 5, 12, 7)]
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    jpcfg = JKC.PagedCacheConfig(num_blocks=16, block_size=4, **pkw)
    jeng = JServeEngine(jparams, jcfg, jax_build_steps(jcfg, pc, mesh, pcfg=jpcfg),
                        jpcfg, JEngineConfig(**ekw))
    pcfg = PagedCacheConfig(num_blocks=16, block_size=4, **pkw)
    eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu"),
                      pcfg, EngineConfig(**ekw))
    for p in prompts:
        jeng.submit(p, 5)
        eng.submit(p, 5)
    jres, res = jeng.run(), eng.run()
    tokens = [r.tokens for r in sorted(res, key=lambda r: r.uid)]
    assert tokens == [r.tokens for r in jres]
    assert eng.stats == jeng.stats
    assert len({t for row in tokens for t in row}) > len(prompts)  # not a repeated token
    assert eng.alloc.num_free == pcfg.num_blocks - 1

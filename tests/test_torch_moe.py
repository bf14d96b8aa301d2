"""The MoE and MLA layers of DeepSeek-V2-236B and Kimi-K2 against the
reference on the CPU.

``apply_moe`` against both of the reference's dispatch formulations
("flat" and "indexed"): output, load-balance and z losses, per-expert
load, at the reduced configs' shapes, with a capacity factor of 0.25 that
drops tokens, without and with shared experts, and with router
probabilities that tie exactly (the lower expert id first, as
``jax.lax.top_k`` documents). ``apply_mla``'s decompressed prefill and its
absorbed decode against the reference's latent cache, with a low-rank
query (``q_lora_rank`` > 0) and a full one (= 0). The config copies field
by field, ``expert_capacity``, and the serving storage of every new leaf.
fp32 on both sides; outputs within 1e-4 of the reference's largest
|value| (the bound of the other model tests), losses within 1e-5
relative, the load's counts exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import mla as PMLA  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402

TOL = 1e-4
LOSS_TOL = 1e-5
ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")


def _jcfg(arch, **kw):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_load(load, jload, assignments):
    """The same assignment count per expert; the share within one rounding
    (the jitted reference divides by a reciprocal)."""
    load, jload = load.numpy(), np.asarray(jload)
    assert np.array_equal(np.rint(load * assignments), np.rint(jload * assignments))
    assert np.allclose(load, jload, rtol=2e-7, atol=0)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_reference(arch, get):
    jc = getattr(jax_configs, get)(arch)
    pc = getattr(pt_configs, get)(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.is_moe and pc.resolved_head_dim == jc.resolved_head_dim
    assert arch in pt_configs.list_architectures()


def test_expert_capacity_matches_reference():
    for arch in ARCHS:
        for factor in (0.25, 1.0, 1.25, 2.0):
            jc = dataclasses.replace(jax_configs.get_config(arch), expert_capacity_factor=factor)
            pc = _port_cfg(jc)
            for T in (1, 4, 7, 64, 512, 2048, 4096 + 3):
                assert PMOE.expert_capacity(T, pc) == JMOE.expert_capacity(T, jc), (arch, T)


# (arch, config overrides, tokens (B, S)): the reduced configs (DeepSeek's
# 1 shared expert, Kimi's), no shared expert, and a capacity factor of 0.25
# under which the experts cannot take every assignment
MOE_CASES = [
    pytest.param("deepseek-v2-236b", {}, (2, 9), id="deepseek-reduced"),
    pytest.param("kimi-k2-1t-a32b", {"num_experts": 8, "num_experts_per_tok": 3}, (3, 7),
                 id="kimi-8-experts-top3"),
    pytest.param("kimi-k2-1t-a32b", {"num_shared_experts": 0}, (2, 8), id="no-shared"),
    pytest.param("deepseek-v2-236b", {"expert_capacity_factor": 0.25, "num_experts": 2,
                                      "num_experts_per_tok": 2}, (4, 12), id="drops-tokens"),
]


@pytest.mark.parametrize("mode", ["flat", "indexed"])
@pytest.mark.parametrize("arch,kw,shape", MOE_CASES)
def test_apply_moe_matches_reference(arch, kw, shape, mode):
    jcfg = _jcfg(arch, **kw)
    cfg = _port_cfg(jcfg)
    p = JMOE.init_moe(jax.random.PRNGKey(1), jcfg)
    # experts 4x the init's std, so the routed products are not lost
    # beside the shared expert
    p = {k: (v * 4 if k.startswith("w_") else v) for k, v in p.items()}
    x = np.random.default_rng(2).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    with JMOE.dispatch_mode(mode):  # read when traced
        jout, jst = jax.jit(lambda p, x: JMOE.apply_moe(p, x, jcfg))(p, jnp.asarray(x))
    out, st = PMOE.apply_moe(_to_torch(p), torch.from_numpy(x), cfg)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert _rel_err(out.numpy(), jout) <= TOL
    for k in ("aux_loss", "z_loss"):
        assert abs(float(st[k]) - float(jst[k])) <= LOSS_TOL * abs(float(jst[k])), k
    T = shape[0] * shape[1]
    _check_load(st["load"], jst["load"], T * cfg.num_experts_per_tok)
    kept_slots = cfg.num_experts * PMOE.expert_capacity(T, cfg)
    if "expert_capacity_factor" in kw:  # some assignments were dropped
        assert kept_slots < T * cfg.num_experts_per_tok
        routed_only = dict(p)
        routed_only.pop("shared")
        full, _ = PMOE.apply_moe(_to_torch(routed_only), torch.from_numpy(x),
                                 cfg.replace(expert_capacity_factor=4.0))
        part, _ = PMOE.apply_moe(_to_torch(routed_only), torch.from_numpy(x), cfg)
        # a dropped assignment's token misses that expert's share
        assert float((full - part).abs().max()) > 1e-3
    if "shared" in p:  # the shared experts are added last
        routed_only = {k: v for k, v in p.items() if k != "shared"}
        routed, _ = PMOE.apply_moe(_to_torch(routed_only), torch.from_numpy(x), cfg)
        shared = PL.apply_mlp(_to_torch(p["shared"]), torch.from_numpy(x), cfg)
        assert torch.allclose(out, routed + shared, atol=1e-6, rtol=0)


def test_moe_top_k_ties_keep_the_lower_expert():
    """Router columns that repeat give probabilities that tie exactly;
    top-k keeps the lower expert id first on both sides."""
    jcfg = _jcfg("kimi-k2-1t-a32b", num_experts=6, num_experts_per_tok=3)
    cfg = _port_cfg(jcfg)
    p = JMOE.init_moe(jax.random.PRNGKey(3), jcfg)
    r = np.array(p["router"])
    r[:, 3], r[:, 4], r[:, 5] = r[:, 1], r[:, 0], r[:, 1]  # 1 = 3 = 5 and 0 = 4
    p = {**p, "router": jnp.asarray(r)}
    x = np.random.default_rng(4).standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, jcfg.d_model)) @ p["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, 3)
    _, _, idx = PMOE.route(torch.from_numpy(x.reshape(-1, jcfg.d_model)) @
                           torch.from_numpy(r), 3)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    jout, jst = jax.jit(lambda p, x: JMOE.apply_moe(p, x, jcfg))(p, jnp.asarray(x))
    out, st = PMOE.apply_moe(_to_torch(p), torch.from_numpy(x), cfg)
    assert _rel_err(out.numpy(), jout) <= TOL
    _check_load(st["load"], jst["load"], x.shape[0] * x.shape[1] * 3)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora_rank96", "q_lora_rank0"])
def test_apply_mla_prefill_and_absorbed_decode_match_reference(q_lora):
    """The decompressed prefill over S tokens, the latent cache made from
    its streams, then 4 absorbed decode steps: each output and the cache
    against the reference's; the last decode step's output also against
    the port's own prefill at that position."""
    jcfg = _jcfg("deepseek-v2-236b", **({} if q_lora else {"q_lora_rank": 0}))
    cfg = _port_cfg(jcfg)
    p = JMLA.init_mla(jax.random.PRNGKey(5), jcfg)
    assert ("w_dq" in p) == q_lora and ("w_q" in p) != q_lora
    pt = _to_torch(p)
    B, S, D, max_len = 2, 10, 4, 16
    x = np.random.default_rng(6).standard_normal((B, S + D, jcfg.d_model)).astype(np.float32)
    pos = jnp.arange(S, dtype=jnp.int32)
    jout, (jckv, jkr) = jax.jit(lambda p, x: JMLA.apply_mla(p, x, jcfg, positions=pos,
                                                            return_kv=True))(
        p, jnp.asarray(x[:, :S]))
    out, (ckv, kr) = PMLA.apply_mla(pt, torch.from_numpy(x[:, :S]), cfg, return_kv=True)
    assert _rel_err(out.numpy(), jout) <= TOL
    assert _rel_err(ckv.numpy(), jckv) <= TOL and _rel_err(kr.numpy(), jkr) <= TOL
    jcache = JMLA.mla_cache_from_kv(jcfg, jckv, jkr, pos, max_len=max_len)
    cache = PMLA.mla_cache_from_kv(cfg, ckv, kr, max_len=max_len)
    jstep = jax.jit(lambda p, x, pos, c: JMLA.apply_mla(p, x, jcfg, positions=pos, cache=c))
    for t in range(D):
        xt = x[:, S + t:S + t + 1]
        jo, jcache = jstep(p, jnp.asarray(xt), jnp.asarray([S + t], jnp.int32), jcache)
        o, cache = PMLA.apply_mla(pt, torch.from_numpy(xt), cfg, cache=cache)
        assert _rel_err(o.numpy(), jo) <= TOL, t
    assert cache["length"] == int(jcache["length"]) == S + D
    assert np.array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for k in ("ckv", "krope"):
        assert _rel_err(cache[k].numpy(), jcache[k]) <= TOL
    full, _ = PMLA.apply_mla(pt, torch.from_numpy(x), cfg)
    assert _rel_err(o.numpy(), full[:, -1:].numpy()) <= TOL


def test_serving_storage_of_the_new_leaves():
    """bf16 serving storage: the experts and MLA's down- and up-projections
    in bf16; the router, ``w_uk`` and ``w_uv`` (read in fp32 by the
    reference) and the norms in fp32, whether made by ``init_params`` or
    carried over from the reference by ``params_from_jax``. The experts are
    made in their storage a slab at a time."""
    cfg = pt_configs.get_reduced_config("deepseek-v2-236b")
    params = PR.init_params(cfg, seed=0, device="cpu")
    dtypes = {n: t.dtype for n, t in param_leaves(params)}
    bf16, f32 = torch.bfloat16, torch.float32
    for name in ("w_dq", "w_uq", "w_dkv", "w_kr", "wo"):
        assert dtypes[f"layers.0.mix.{name}"] == bf16, name
    for name in ("w_uk", "w_uv", "q_norm", "kv_norm"):
        assert dtypes[f"layers.0.mix.{name}"] == f32, name
    for name in ("w_gate", "w_up", "w_down", "shared.w_gate", "shared.w_up", "shared.w_down"):
        assert dtypes[f"layers.1.mlp.{name}"] == bf16, name
    assert dtypes["layers.1.mlp.router"] == f32
    assert dtypes["layers.0.mlp.w_up"] == bf16 and "layers.0.mlp.router" not in dtypes
    q0 = PR.init_params(cfg.replace(q_lora_rank=0), seed=0, device="cpu")
    assert q0["layers"][0]["mix"]["w_q"].dtype == bf16
    # the reference's tree carried over: the same leaf names in the
    # reference's leaf order, each in the same storage
    jtree = JR.init_params(jax.random.PRNGKey(0), jax_configs.get_reduced_config(
        "deepseek-v2-236b"))
    jnames = [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    carried = params_from_jax(jax.tree.map(np.asarray, jtree), cfg, device="cpu")
    assert [n for n, _ in param_leaves(carried)] == jnames
    assert {n: t.dtype for n, t in param_leaves(carried)} == dtypes
    # a slab of one expert at a time: the same shapes, dtype and scale
    gen = torch.Generator().manual_seed(0)
    old = PMOE.SLAB_ELEMENTS
    try:
        PMOE.SLAB_ELEMENTS = cfg.d_model * cfg.moe_d_ff
        slabbed = PMOE.init_moe(gen, cfg)
    finally:
        PMOE.SLAB_ELEMENTS = old
    w = slabbed["w_up"]
    assert w.shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff) and w.dtype == bf16
    assert 0.015 < float(w.float().std()) < 0.02 and float(w.float().abs().max()) <= 0.0605

"""The backward of DeepSeek-V2-236B's and Kimi-K2's layers against
``jax.grad`` of the reference, on the CPU, fp32, at the reduced configs.

- ``apply_moe`` in the reference's training mode ("flat"): the gradients
  of the output (against a random cotangent), of the load-balance loss and
  of the z-loss with respect to x, the router, the routed experts and the
  shared expert, at capacity factor 1.25 (every assignment kept) and 0.25
  (assignments dropped: their gradient is zero on both sides), and with
  router probabilities that tie exactly.
- ``apply_mla``'s decompressed path at ``q_lora_rank`` 96 and 0.
- ``loss_fn``'s value and every gradient leaf of both reduced models
  against ``jax.value_and_grad`` of the reference's ``loss_fn``.
- ``decay_mask`` leaf for leaf against the reference's AdamW mask.
- The backward twice on the same inputs: the same bits.

Every gradient within 1e-5 (``test_torch_qwen3.py``'s bound; measured
at most 2e-7), the loss within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import mla as PMLA  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402

TOL = 1e-5
ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's tests, the count restored after:
    the reduced models' operations are too small to share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# the reference's init_params as one program: the eager calls' bits
# without their per-operation compiles
REFERENCE_INIT = jax.jit(JR.init_params, static_argnums=1)


def _jcfg(arch, **kw):
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _with_grad(tree):
    """A reference tree of arrays as fp32 torch leaves that require grad."""
    return jax.tree.map(lambda a: torch.tensor(np.array(a, np.float32), requires_grad=True),
                        tree)


def _grad_errors(port_tree, jgrads):
    """{leaf path: max |port grad - reference grad|}; a leaf with no grad
    on the port's side counts as zeros."""
    out = {}
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree_util.tree_leaves(port_tree)):
        mine = t.grad.numpy() if t.grad is not None else np.zeros(t.shape, np.float32)
        out[jax.tree_util.keystr(path)] = float(np.abs(mine - np.asarray(g)).max())
    return out


# (arch, config overrides, tokens (B, S)); the router's columns tie in the
# last case (1 = 3 = 5 and 0 = 4)
MOE_CASES = [
    pytest.param("deepseek-v2-236b", {}, (2, 9), False, id="capacity-1.25"),
    pytest.param("deepseek-v2-236b", {"expert_capacity_factor": 0.25, "num_experts": 2,
                                      "num_experts_per_tok": 2}, (4, 12), False,
                 id="capacity-0.25-drops"),
    pytest.param("kimi-k2-1t-a32b", {"num_experts": 6, "num_experts_per_tok": 3}, (2, 6),
                 True, id="exact-ties"),
]


OBJECTIVES = ("out", "aux_loss", "z_loss")
_REFERENCE_MOE_GRADS = {}


def _moe_case(arch, kw, shape, ties):
    """The case's inputs and the reference's gradients of every objective,
    from one jitted function (made once a case, for its three tests)."""
    key = (arch, tuple(sorted(kw.items())), shape, ties)
    if key not in _REFERENCE_MOE_GRADS:
        jcfg = _jcfg(arch, **kw)
        p = JMOE.init_moe(jax.random.PRNGKey(1), jcfg)
        p = {k: (v * 4 if k.startswith("w_") else v) for k, v in p.items()}
        if ties:
            r = np.array(p["router"])
            r[:, 3], r[:, 4], r[:, 5] = r[:, 1], r[:, 0], r[:, 1]
            p["router"] = jnp.asarray(r)
        rng = np.random.default_rng(2)
        x = rng.standard_normal((*shape, jcfg.d_model)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)

        def grads(p, x):
            def value(p, x, objective):
                out, stats = JMOE.apply_moe(p, x, jcfg)
                return (out * ct).sum() if objective == "out" else stats[objective]
            return {o: jax.grad(value, argnums=(0, 1))(p, x, o) for o in OBJECTIVES}

        with JMOE.dispatch_mode("flat"):  # read when traced
            _REFERENCE_MOE_GRADS[key] = (jcfg, p, x, ct,
                                         jax.jit(grads)(p, jnp.asarray(x)))
    return _REFERENCE_MOE_GRADS[key]


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("arch,kw,shape,ties", MOE_CASES)
def test_apply_moe_grads_match_reference_flat_mode(arch, kw, shape, ties, objective):
    jcfg, p, x, ct, jgrads = _moe_case(arch, kw, shape, ties)
    cfg = _port_cfg(jcfg)
    jgp, jgx = jgrads[objective]

    def value(out, stats, ct):
        return (out * ct).sum() if objective == "out" else stats[objective]

    pt, xt = _with_grad(p), torch.tensor(x, requires_grad=True)
    value(*PMOE.apply_moe(pt, xt, cfg), torch.from_numpy(ct)).backward()
    errs = _grad_errors(pt, jgp)
    errs["x"] = float(np.abs(xt.grad.numpy() - np.asarray(jgx)).max())
    assert max(errs.values()) <= TOL, errs
    T = shape[0] * shape[1]
    if "expert_capacity_factor" in kw:  # some assignments were dropped
        assert cfg.num_experts * PMOE.expert_capacity(T, cfg) < T * cfg.num_experts_per_tok
    if objective == "out":  # every routed expert and the shared one learn
        assert float(pt["w_up"].grad.abs().amax(dim=(1, 2)).min()) > 0
        assert float(pt["shared"]["w_up"].grad.abs().max()) > 0
    else:  # the router losses reach the router alone (``fe`` is a count)
        assert pt["w_up"].grad is None and float(pt["router"].grad.abs().max()) > 0


def test_dropped_assignments_get_no_gradient():
    """Two experts of capacity 8 for 24 tokens choosing both: the tokens
    past the first 8 are dropped by both experts, so without a shared
    expert their input's gradient from the output is the router's alone,
    and a cotangent on those tokens leaves the experts untouched."""
    jcfg = _jcfg("deepseek-v2-236b", expert_capacity_factor=0.25, num_experts=2,
                 num_experts_per_tok=2, num_shared_experts=0)
    cfg = _port_cfg(jcfg)
    p = _with_grad(JMOE.init_moe(jax.random.PRNGKey(4), jcfg))
    x = torch.tensor(np.random.default_rng(5).standard_normal((1, 24, jcfg.d_model))
                     .astype(np.float32), requires_grad=True)
    C = PMOE.expert_capacity(24, cfg)
    assert C == 8
    out, _ = PMOE.apply_moe(p, x, cfg)
    assert float(out.detach()[0, C:].abs().max()) == 0.0  # dropped by both experts
    out[0, C:].sum().backward()
    for name in ("w_gate", "w_up", "w_down"):
        assert float(p[name].grad.abs().max()) == 0.0, name


@pytest.mark.parametrize("q_lora", [96, 0], ids=["q_lora_rank96", "q_lora_rank0"])
def test_apply_mla_grads_match_reference(q_lora):
    """The decompressed (training) path: gradients of the output against a
    random cotangent, with respect to x and every MLA leaf (the latent
    norms' scales included)."""
    jcfg = _jcfg("deepseek-v2-236b", q_lora_rank=q_lora)
    cfg = _port_cfg(jcfg)
    p = JMLA.init_mla(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(7)
    p = {k: v * np.float32(rng.uniform(0.5, 1.5)) if k.endswith("norm") else v
         for k, v in p.items()}  # scales other than one
    B, S = 2, 11
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = jnp.arange(S, dtype=jnp.int32)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, x: (JMLA.apply_mla(p, x, jcfg, positions=pos)[0] * ct).sum(),
        argnums=(0, 1)))(p, jnp.asarray(x))
    pt, xt = _with_grad(p), torch.tensor(x, requires_grad=True)
    out, _ = PMLA.apply_mla(pt, xt, cfg)
    (out * torch.from_numpy(ct)).sum().backward()
    errs = _grad_errors(pt, jgp)
    errs["x"] = float(np.abs(xt.grad.numpy() - np.asarray(jgx)).max())
    assert max(errs.values()) <= TOL, errs
    assert ("['q_norm']" in errs) == (q_lora > 0)


def _loss_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels[0, :4] = -1
    return toks, labels


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grads_match_reference(arch):
    """The total loss (cross-entropy, ``router_aux_loss_coef * moe_aux`` and
    ``1e-4 * moe_z``) and every gradient leaf, the dense layer's, the MoE
    layer's and MLA's included, within 1e-5."""
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, REFERENCE_INIT(jax.random.PRNGKey(2), jcfg))
    toks, labels = _loss_inputs(cfg, 3)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JR.loss_fn(p, jcfg, jb),
                                              has_aux=True))(jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    loss, m = PR.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    for k in ("moe_aux", "moe_z", "lm_loss"):
        assert abs(float(m[k].detach()) - float(jm[k])) <= TOL * abs(float(jm[k])), k
    assert float(m["moe_aux"].detach()) > 0  # the MoE layer ran
    leaves = param_leaves(params)
    assert len(leaves) == len(_leaves_np(jg))
    for (name, t), g in zip(leaves, _leaves_np(jg)):
        assert t.grad is not None, name
        assert np.abs(t.grad.numpy() - g).max() <= TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_reference(arch):
    """Weight decay on every matmul (the router, the routed and shared
    experts, every MLA projection), none on the norm scales, ``q_norm`` and
    ``kv_norm``: leaf for leaf the reference's, in its leaf order."""
    jcfg = _jcfg(arch)
    jtree = REFERENCE_INIT(jax.random.PRNGKey(0), jcfg)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    want = [JA._decay_mask(path) for path, _ in flat]
    params = params_from_jax(jax.tree.map(np.asarray, jtree), _port_cfg(jcfg), device="cpu",
                             training=True)
    names = [n for n, _ in param_leaves(params)]
    assert [PA.decay_mask(n) for n in names] == want
    decays = dict(zip(names, want))
    assert decays["layers.1.mlp.router"] and decays["layers.1.mlp.shared.w_down"]
    assert decays["layers.1.mlp.w_gate"] and not decays["layers.1.norm2.scale"]
    if jcfg.attention_kind == "mla":
        assert not decays["layers.0.mix.q_norm"] and not decays["layers.0.mix.kv_norm"]
        assert decays["layers.0.mix.w_uk"] and decays["layers.0.mix.w_dkv"]


@pytest.mark.parametrize("arch", ARCHS)
def test_backward_gives_the_same_bits_twice(arch):
    """Two backward passes of ``loss_fn`` from the same parameters and
    batch: every gradient leaf bit for bit (the dispatch's backward has no
    accumulate whose order is free)."""
    cfg = _port_cfg(_jcfg(arch))
    params = PR.init_params(cfg, seed=3, device="cpu", training=True)
    toks, labels = _loss_inputs(cfg, 8)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    grads = []
    for _ in range(2):
        loss, _ = PR.loss_fn(params, cfg, batch)
        loss.backward()
        grads.append([t.grad.clone() for _, t in param_leaves(params)])
        for _, t in param_leaves(params):
            t.grad = None
    for (name, _), a, b in zip(param_leaves(params), *grads):
        assert torch.equal(a, b), name


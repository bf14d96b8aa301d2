"""Qwen3-1.7B, the port's first RMSNorm family, against the reference on the CPU.

The config copy; the RMSNorm kernel's plain version against the reference's
Pallas kernel in interpret mode and against its norms; the plain backward
against ``jax.vjp``; the CUDA path's autograd contract; RoPE; SwiGLU; the
forward, loss and gradients on parameters carried over with
``params_from_jax``; greedy paged generation against the reference's
engine; a 12-step ``SimulatedRun`` against the reference simulator; and
generation from parameters in training storage. Inputs are made with numpy
from a seed and handed to both packages, at the reduced size (2 layers,
d_model 256) and one narrow case at head_dim 128.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
import repro.configs as jax_configs  # noqa: E402
from repro.config import ParallelConfig  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.launch import mesh as M  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel.steps import build_paged_serve_steps as jax_build_steps  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import rmsnorm as RK  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.parallel.steps import build_paged_serve_steps  # noqa: E402
from repro_torch.serve import (EngineConfig, PagedCacheConfig, ServeEngine,  # noqa: E402
                               generate)

ARCH = "qwen3-1.7b"
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _jcfg(**kw):
    """The reduced Qwen3 config in fp32 (RoPE, qk-norm, SwiGLU, GQA 2:1)."""
    return dataclasses.replace(jax_configs.get_reduced_config(ARCH), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0, gain=1.0):
    """Reference parameters as numpy, matmul weights times ``gain``: at the
    init's std of 0.02 a 2-layer model's greedy tokens only repeat the last
    prompt token (tied embeddings), which would hide a fault in the layers."""
    params = JR.init_params(jax.random.PRNGKey(seed), jcfg)

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _close_bf16(a, b, atol=0.0):
    """Elementwise within one bf16 ulp of b (fp32 arrays of bf16 values),
    plus ``atol``."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return bool(np.all(np.abs(a - b) <= ulp + atol))


# ===========================================================================
# config
# ===========================================================================


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
def test_qwen3_config_equals_reference(get):
    jc, pc = getattr(jax_configs, get)(ARCH), getattr(pt_configs, get)(ARCH)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pt_configs.get_config("qwen3_1_7b") == pt_configs.get_config(ARCH)


# ===========================================================================
# RMSNorm: plain version vs the Pallas kernel and the reference's norms
# ===========================================================================


@pytest.mark.parametrize("D", [128, 2048, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_plain_vs_pallas_and_reference_norms(D, dtype, eps):
    """``ops.rmsnorm`` on a CPU tensor (the plain version) against the
    reference's Pallas kernel in interpret mode, ``apply_norm`` and
    ``rms_norm_headwise``; and the port's ``apply_norm`` /
    ``rms_norm_headwise`` against the same. Within 1e-6 of the largest
    output in fp32 (other summation orders), one bf16 ulp in bf16."""
    rng = np.random.default_rng(D)
    x = (rng.standard_normal((3, 5, D)) * 2 + 0.5).astype(np.float32)
    s = rng.standard_normal(D).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jcfg = dataclasses.replace(_jcfg(), norm_eps=eps)
    refs = [jax_rmsnorm(jx, jnp.asarray(s), eps=eps, block_rows=2, interpret=True),
            JL.apply_norm({"scale": jnp.asarray(s)}, jx, jcfg),
            JL.rms_norm_headwise(jx, jnp.asarray(s), eps)]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts = torch.from_numpy(s)
    outs = [kops.rmsnorm(tx, ts, eps=eps), PL.apply_norm({"scale": ts}, tx, _port_cfg(jcfg)),
            PL.rms_norm_headwise(tx, ts, eps)]
    for out in outs:
        assert out.dtype == tx.dtype and out.shape == tx.shape
        a = out.float().numpy()
        for ref in refs:
            b = np.asarray(ref.astype(jnp.float32))
            if dtype == "float32":
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
            else:
                assert _close_bf16(a, b)


@pytest.mark.parametrize("D", [128, 2048, 40])
def test_rmsnorm_backward_plain_vs_jax_vjp(D):
    """``rmsnorm_bwd_ref`` and autograd through the CPU path against
    ``jax.vjp`` of the reference's ``rmsnorm_ref``, fp32: dx within 2e-6 of
    its largest element, dscale within 1e-5 of its largest."""
    rng = np.random.default_rng(D + 1)
    x = (rng.standard_normal((7, D)) * 3).astype(np.float32)
    s = rng.standard_normal(D).astype(np.float32)
    g = rng.standard_normal((7, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: JREF.rmsnorm_ref(a, b, eps=1e-6),
                     jnp.asarray(x), jnp.asarray(s))
    jdx, jds = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dx, ds = R.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(g), eps=1e-6)
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    kops.rmsnorm(xt, st, eps=1e-6).backward(torch.from_numpy(g))
    for a, b in ((dx, xt.grad), (ds, st.grad)):
        assert a.dtype == torch.float32
    for got_dx, got_ds in ((dx, ds), (xt.grad, st.grad)):
        assert np.abs(got_dx.numpy() - jdx).max() <= 2e-6 * np.abs(jdx).max()
        assert np.abs(got_ds.numpy() - jds).max() <= 1e-5 * np.abs(jds).max()


def test_rmsnorm_autograd_function_contract(monkeypatch):
    """On a CUDA tensor that needs a gradient ``rmsnorm`` is ``RMSNormFn``:
    the forward hands its rstd to the backward, which returns dx and
    dscale. Here the kernel launches are replaced by their plain versions,
    so the contract runs on the CPU; the kernels are checked on the card by
    chip_smoke.py."""
    calls = []

    def fake_fwd(x, scale, eps, want_rstd):
        calls.append("fwd")
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(-1) + eps).reshape(-1)
        return R.rmsnorm_ref(x, scale, eps=eps), (rstd if want_rstd else None)

    def fake_bwd(x, scale, rstd, dy):
        calls.append("bwd")
        assert rstd.shape == (x.numel() // x.shape[-1],) and rstd.dtype == torch.float32
        return R.rmsnorm_bwd_ref(x, scale, dy, eps=1e-6)

    monkeypatch.setattr(RK, "_launch_fwd", fake_fwd)
    monkeypatch.setattr(RK, "_launch_bwd", fake_bwd)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    xt, st = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    out = RK.RMSNormFn.apply(xt, st, 1e-6)
    assert "RMSNormFn" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    assert calls == ["fwd", "bwd"]
    xr, sr = torch.from_numpy(x).requires_grad_(), torch.from_numpy(s).requires_grad_()
    R.rmsnorm_ref(xr, sr, eps=1e-6).backward(torch.from_numpy(g))
    assert float((xt.grad - xr.grad).abs().max()) <= 1e-5
    assert float((st.grad - sr.grad).abs().max()) <= 1e-5


def test_rmsnorm_never_runs_plain_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path, which refuses what it cannot launch."""
    z = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        RK.rmsnorm(z, torch.zeros(16, device="meta"))
    with pytest.raises(ValueError, match="do not match"):
        RK.rmsnorm(torch.zeros(4, 16), torch.zeros(8))
    launched = (RK.launches, RK.bwd_launches)
    RK.rmsnorm(torch.ones(4, 16, requires_grad=True), torch.ones(16)).sum().backward()
    assert (RK.launches, RK.bwd_launches) == launched


# ===========================================================================
# RoPE and SwiGLU
# ===========================================================================


@pytest.mark.parametrize("pos_dims", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(pos_dims, dtype):
    """(S,) positions as in the forward, (B, S) as in the decode step; theta
    1e6 and head_dim 128 as Qwen3. fp32 within 1e-5 (XLA's and torch's sin,
    cos and pow), bf16 within one ulp plus 1e-6 (``x1 cos - x2 sin`` may
    cancel to near zero, where the fp32 difference exceeds an ulp)."""
    rng = np.random.default_rng(pos_dims)
    x = rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
    pos = (np.arange(9, dtype=np.int32) if pos_dims == 1
           else rng.integers(0, 4000, (2, 9)).astype(np.int32))
    ref = JL.apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 1e6)
    out = PL.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos), 1e6)
    a, b = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert np.abs(a - b).max() <= 1e-5
    else:
        assert _close_bf16(a, b, atol=1e-6)


def test_swiglu_mlp_matches_reference():
    jcfg = _jcfg()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(shape) * 0.05).astype(np.float32)
         for k, shape in (("w_gate", (jcfg.d_model, jcfg.d_ff)),
                          ("w_up", (jcfg.d_model, jcfg.d_ff)),
                          ("w_down", (jcfg.d_ff, jcfg.d_model)))}
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    out = PL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), _port_cfg(jcfg))
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5
    init = PL.init_mlp(torch.Generator().manual_seed(0), _port_cfg(jcfg))
    assert sorted(init) == ["w_down", "w_gate", "w_up"]


# ===========================================================================
# the model: parameters, forward, loss and gradients
# ===========================================================================


def test_params_from_jax_carries_qwen3_leaves():
    """q_norm / k_norm (1-D, beside the 3-D projections) and w_gate carry
    over with the reference's keys, shapes and order; 11 leaves a layer;
    the decay mask gives the reference's decay to every leaf."""
    jcfg = jax_configs.get_reduced_config(ARCH)  # bf16 compute, fp32 params
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg)
    jpaths, flags = [], []

    def record(path, x):
        jpaths.append("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path))
        flags.append(JA._decay_mask(path))
        return x

    jax.tree_util.tree_map_with_path(record, tree)
    for training in (False, True):
        params = params_from_jax(tree, cfg, device="cpu", training=training)
        leaves = param_leaves(params)
        assert [n.replace(".", "/") for n, _ in leaves] == jpaths
        assert len(leaves) == 11 * cfg.num_layers + 2
        for (name, t), x in zip(leaves, _leaves_np(tree)):
            assert tuple(t.shape) == x.shape
            want = (torch.bfloat16 if name.rsplit(".", 1)[-1] in MATMUL_LEAVES
                    and not training else torch.float32)
            assert t.dtype == want, name
        assert [PA.decay_mask(n) for n, _ in leaves] == flags
    assert tuple(params.state_dict()["layers.0.mix.q_norm"].shape) == (cfg.resolved_head_dim,)
    fresh = PR.init_params(cfg, device="cpu")
    assert set(fresh.state_dict()) == set(params.state_dict())


@pytest.mark.parametrize("head_dim", [64, 128])
def test_forward_matches_reference(head_dim):
    """Logits and the collected K/V streams (k after qk-norm and RoPE)
    within 1e-5, fp32."""
    jcfg = _jcfg(head_dim=head_dim)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=1, gain=4.0)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ref, jaux = JR.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, collect_kv=True)
    out, aux = PR.forward(params, cfg, {"tokens": torch.from_numpy(toks)}, collect_kv=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5
    for (k, v), (jk, jv) in zip(aux["kv"], jaux["kv"]):
        assert np.abs(k.numpy() - np.asarray(jk)).max() <= 1e-5
        assert np.abs(v.numpy() - np.asarray(jv)).max() <= 1e-5


def test_loss_fn_value_and_grads_match_reference():
    """fp32 loss and every gradient leaf (norm scales, qk-norm and w_gate
    included) within 1e-5 of ``jax.value_and_grad(repro...loss_fn)``."""
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=2, gain=4.0)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels[0, :4] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl, _), jg = jax.value_and_grad(lambda p: JR.loss_fn(p, jcfg, jb), has_aux=True)(jparams)
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    loss, _ = PR.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for (name, t), g in zip(param_leaves(params), _leaves_np(jg)):
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5, name


# ===========================================================================
# serving: greedy paged generation against the reference's engine
# ===========================================================================


@pytest.mark.parametrize("kv,head_dim", [pytest.param("bfloat16", 64, id="bfloat16"),
                                         pytest.param("int8", 64, id="int8"),
                                         pytest.param("int8", 128, id="int8-hd128")])
def test_greedy_generation_matches_reference_engine(kv, head_dim):
    """Six prompts of mixed lengths through both continuous-batching
    engines (3 slots, block 4): identical greedy tokens and engine stats,
    with bf16 K/V pools and with int8 blocks (block = head_dim), int8 also
    at Qwen3-1.7B's head_dim 128."""
    jcfg = _jcfg(head_dim=head_dim)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=3, gain=4.0)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, device="cpu")
    pkw = (dict(quantized=True) if kv == "int8" else dict(dtype="bfloat16"))
    ekw = dict(max_slots=3, max_new_tokens=5, max_blocks_per_seq=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 9, 5, 12, 2, 7)]
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    jpcfg = JKC.PagedCacheConfig(num_blocks=20, block_size=4, **pkw)
    jeng = JServeEngine(jparams, jcfg, jax_build_steps(jcfg, pc, mesh, pcfg=jpcfg),
                        jpcfg, JEngineConfig(**ekw))
    pcfg = PagedCacheConfig(num_blocks=20, block_size=4, **pkw)
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


def test_generate_from_training_storage_matches_serving_storage():
    """GPT-2 (learned positions) and Qwen3 in bf16 compute: parameters in
    training storage (fp32 masters, cast at use) generate the same tokens
    as the same parameters in serving storage."""
    rng = np.random.default_rng(4)
    for name in ("gpt2-xl", ARCH):
        jcfg = jax_configs.get_reduced_config(name)
        cfg = _port_cfg(jcfg)
        tree = _tree(jcfg, seed=5, gain=4.0)
        prompts = rng.integers(0, cfg.vocab_size, (2, 6))
        outs = [generate(params_from_jax(tree, cfg, device="cpu", training=t), cfg,
                         prompts, 6)[0] for t in (True, False)]
        np.testing.assert_array_equal(outs[0], outs[1])


def test_launcher_serves_qwen3_on_the_cpu(capsys):
    out, info = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "5", "--tokens", "3",
                                   "--int8-kv"])
    assert out.shape == (2, 3) and info["engine"].stats["prefills"] == 2
    assert "arch=qwen3-1.7b-reduced path=paged device=cpu" in capsys.readouterr().out


# ===========================================================================
# training: SimulatedRun against the reference simulator
# ===========================================================================

TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)


def test_simulated_run_matches_reference():
    """12 steps at G = 2, flat fp32 outer sync, delay 0 (lazy start, two
    warmup accumulates, the switch to groups and four outer syncs): every
    step's loss within 1e-5 of the reference. The final parameters: each
    leaf's difference within 1e-4 of how far the leaf moved (L2 norms) and
    every element within 1.5e-4. AdamW's normalized step turns rounding
    differences in a gradient element near its eps into a sizeable part of
    lr, so the elementwise 1e-5 of the 64-wide model in test_torch_train.py
    does not hold at width 256. Reduced GPT-2 XL, also 256 wide and with
    none of Qwen3's layers, shows it too. Measured with 1 to 8 CPU threads:
    Qwen3 1.18e-4 elementwise and 3.5e-5 of the movement, GPT-2 XL 5.7e-5 to
    8.5e-5 and 1.9e-5 to 2.7e-5; losses 1.4e-6 at most."""
    _simulated_run_vs_reference(ARCH)


def test_simulated_run_gpt2_xl_at_width_256_matches_reference():
    """The same run and limits on reduced GPT-2 XL: the elementwise gap at
    width 256 comes from AdamW, not from Qwen3's layers."""
    _simulated_run_vs_reference("gpt2-xl")


def _simulated_run_vs_reference(arch):
    jcfg = dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")
    cfg = _port_cfg(jcfg)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32) for _ in range(12)]
    jr = JaxRun(jcfg, jax_config.TrainConfig(**TC_KW), num_groups=2, seed=0)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr = SimulatedRun(cfg, pt_config.TrainConfig(**TC_KW), num_groups=2, device="cpu",
                      params=params_from_jax(tree, cfg, device="cpu", training=True))
    pr._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                  "labels": torch.from_numpy(batches[s][:, 1:])}
    jh, ph = jr.run(12), pr.run(12)
    jr.flush()
    pr.flush()
    np.testing.assert_allclose(ph["train_loss"], jh["train_loss"], rtol=0, atol=1e-5)
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs) == 6
    for (name, t), x, x0 in zip(param_leaves(pr.eval_params()), _leaves_np(jr.eval_params()),
                                _leaves_np(tree)):
        d = t.detach().numpy() - x
        assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(x - x0), name
        assert np.abs(d).max() <= 1.5e-4, name

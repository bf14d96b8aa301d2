"""MiniCPM-2B, Granite-8B and Qwen3-14B against the reference on the CPU.

The three dense RMSNorm families that need nothing but their config copies:
MiniCPM-2B (MHA at head_dim 64, a tied table of 122 753 rows, the WSD
inner schedule), Granite-8B (GQA 4:1, an untied ``lm_head``, RoPE theta
1e7) and Qwen3-14B (GQA 5:1 at head_dim 128, qk-norm, untied). Each config
copy is checked field by field; at the reduced configs (fp32) the forward,
loss and every gradient leaf, ``lm_head``'s included, are held against the
reference's, on the same numpy weights carried over with
``params_from_jax``; RoPE at theta 1e7 over positions up to 512; WSD's
``lr_at`` bit for bit and a 12-step MiniCPM ``SimulatedRun`` against the
reference simulator. Their paged serving is held against the reference's
engine in tests/test_torch_families_serve.py.
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
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim.schedules import lr_at as jax_lr_at  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim.schedules import lr_at  # noqa: E402

FAMILIES = ("minicpm-2b", "granite-8b", "qwen3-14b")
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


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


# ===========================================================================
# the config copies
# ===========================================================================


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_copy_equals_reference(arch, get):
    jc, pc = getattr(jax_configs, get)(arch), getattr(pt_configs, get)(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pt_configs.get_config(arch.replace("-", "_")) == pt_configs.get_config(arch)
    assert arch in jax_configs.list_architectures() and arch in pt_configs.list_architectures()


def test_family_head_layouts():
    """What the slice exercises at full width: MHA at hd 64 with 36 heads,
    GQA 4:1 and 5:1 at hd 128, tied and untied tables."""
    got = {a: (c.num_heads, c.num_kv_heads, c.resolved_head_dim, c.tie_embeddings,
               c.vocab_size) for a, c in ((a, pt_configs.get_config(a)) for a in FAMILIES)}
    assert got == {"minicpm-2b": (36, 36, 64, True, MINICPM_VOCAB),
                   "granite-8b": (32, 8, 128, False, 49_152),
                   "qwen3-14b": (40, 8, 128, False, 151_936)}


# ===========================================================================
# forward, loss and gradients (untied lm_head, odd vocabulary)
# ===========================================================================

# the reduced configs; MiniCPM also with an odd vocabulary (its own 122 753
# rows are served below), Qwen3-14B also at 5:1 (the reduced config is 8:2)
MODEL_CASES = [pytest.param("minicpm-2b", {}, id="minicpm-2b"),
               pytest.param("minicpm-2b", {"vocab_size": 1021}, id="minicpm-2b-odd-vocab"),
               pytest.param("granite-8b", {}, id="granite-8b"),
               pytest.param("qwen3-14b", {"num_heads": 10, "num_kv_heads": 2,
                                          "head_dim": 128}, id="qwen3-14b-5to1")]


@pytest.mark.parametrize("arch,kw", MODEL_CASES)
def test_forward_loss_and_grads_match_reference(arch, kw):
    """Logits, loss and every gradient leaf (``lm_head``'s with an untied
    table) within 1e-5 of the reference's largest value, fp32."""
    jcfg = _jcfg(arch, **kw)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    labels[0, :4] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    ref, _ = jax.jit(lambda p: JR.forward(p, jcfg, jb))(jparams)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: JR.loss_fn(p, jcfg, jb),
                                             has_aux=True))(jparams)
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        logits, _ = PR.forward(params, cfg, pb)
    assert logits.shape == (2, 17, cfg.vocab_size)
    assert _rel_err(logits.numpy(), np.asarray(ref)) <= 1e-5
    loss, _ = PR.loss_fn(params, cfg, pb)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    names = [n for n, _ in param_leaves(params)]
    assert ("embed.lm_head" in names) == (not cfg.tie_embeddings)
    for (name, t), g in zip(param_leaves(params), _leaves_np(jg)):
        assert t.grad.shape == g.shape
        assert _rel_err(t.grad.numpy(), g) <= 1e-5, name


@pytest.mark.parametrize("head_dim", [32, 128])
def test_rope_at_granite_theta_matches_reference(head_dim):
    """Granite's theta 1e7: the fp32 frequencies and the rotation over
    positions 0-512 (one batch row each way) within 1e-5 of the reference."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 513, 2, head_dim)).astype(np.float32)
    pos = np.stack([np.arange(513), rng.permutation(513)]).astype(np.int32)
    assert np.array_equal(PL.rope_frequencies(head_dim, 1e7).numpy(),
                          np.asarray(JL.rope_frequencies(head_dim, 1e7)))
    for p in (pos[0], pos):
        ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e7)
        out = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e7)
        assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


# ===========================================================================
# MiniCPM's WSD schedule and a training run
# ===========================================================================


def test_wsd_lr_at_is_the_references_bit_for_bit():
    """Every step of a 40-step WSD schedule (warmup 4, stable, the decay
    over the last 10% and past the end) equals the reference's fp32 value."""
    tc = dict(total_steps=40, lr_schedule="wsd", lr_warmup_frac=0.1, inner_lr=1e-3,
              inner_min_lr=1e-4, wsd_decay_frac=0.1)
    jtc, ptc = jax_config.TrainConfig(**tc), pt_config.TrainConfig(**tc)
    got = np.array([lr_at(ptc, s) for s in range(44)], np.float32)
    want = np.array([jax_lr_at(jtc, jnp.int32(s)) for s in range(44)], np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    assert got[4] == got[36] == np.float32(1e-3) and got[38] < got[37] < got[36]
    assert got[39] > got[40] == got[43]


TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4, lr_schedule="wsd",
             wsd_decay_frac=0.5, sync_delay=1)


def _port_run(cfg, tree, batches):
    run = SimulatedRun(cfg, pt_config.TrainConfig(**TC_KW), num_groups=2, device="cpu",
                       params=params_from_jax(tree, cfg, device="cpu", training=True))
    run._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                   "labels": torch.from_numpy(batches[s][:, 1:])}
    return run


def test_minicpm_simulated_run_matches_reference():
    """12 steps of reduced MiniCPM at G = 2, delay 1, WSD (the decay starts
    at step 20 of 40: warmup and the stable part run; the LR each step took
    is the reference's ``lr_at``): every loss within 1e-5, as in
    tests/test_torch_train.py, and every final parameter within that
    file's 1e-5 but for the elements that the first step parts.

    AdamW's first update is lr·g/(|g| + eps), so where the first gradient
    is within a few eps (1e-8) of zero the two packages' other summation
    orders decide how far the element moves. The test shows it: after
    step 0 every element further off than 1e-5 has a reference |g| below
    10 eps (measured: 16 of 1.7 M elements, |g| at most 3.5e-8, off by at
    most 1.1e-4). Given the reference's state after step 0, the port's
    other 11 steps hold every element to 1e-5 (measured 1.1e-6). Run on
    from its own step 0, the port carries those elements' offsets through
    the forward into other gradients: at most 0.1% of a leaf's elements
    may then lie beyond 1e-5, each within 5e-4 (measured: 249 elements,
    38 of 82 944 at most in one leaf, 3.7e-4 at most)."""
    jcfg = _jcfg("minicpm-2b")
    cfg = _port_cfg(jcfg)
    jtc = jax_config.TrainConfig(**TC_KW)
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32) for _ in range(12)]
    jr = JaxRun(jcfg, jtc, num_groups=2, seed=0)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr, resynced = _port_run(cfg, tree, batches), _port_run(cfg, tree, batches)
    losses, first = jr.run(1)["train_loss"], [pr.run(1), resynced.run(1)]
    step0 = [_leaves_np(x) for x in (jr.state.params, jr.state.opt.mu, jr.state.opt.nu)]
    for (name, t), x, nu in zip(param_leaves(pr.state.params), step0[0], step0[2]):
        far = np.abs(t.detach().numpy() - x) > 1e-5
        g = np.sqrt(nu[far] / (1 - jtc.adam_beta2))  # the first step's |g|
        assert (g < 10 * jtc.adam_eps).all(), (name, g.max())
    with torch.no_grad():  # the reference's state after step 0
        for dst, src in zip(([t for _, t in param_leaves(resynced.state.params)],
                             resynced.state.opt.mu, resynced.state.opt.nu), step0):
            for t, x in zip(dst, src):
                t.copy_(torch.tensor(x))
    losses += jr.run(11)["train_loss"]
    for run, h in zip((pr, resynced), first):
        rest = run.run(11)
        np.testing.assert_allclose(h["train_loss"] + rest["train_loss"], losses, rtol=0,
                                   atol=1e-5)
        assert h["lr"] + rest["lr"] == [float(jax_lr_at(jtc, jnp.int32(s))) for s in range(12)]
    for run in (jr, pr, resynced):
        run.flush()
    assert pr.state.outer.num_syncs == resynced.state.outer.num_syncs == int(
        jr.state.outer.num_syncs)
    ref = _leaves_np(jr.eval_params())
    for (name, t), x in zip(param_leaves(resynced.eval_params()), ref):
        assert np.abs(t.detach().numpy() - x).max() <= 1e-5, name
    for (name, t), x in zip(param_leaves(pr.eval_params()), ref):
        d = np.abs(t.detach().numpy() - x)
        assert (d > 1e-5).sum() <= 1e-3 * d.size, name
        assert d.max() <= 5e-4, name

"""Training RecurrentGemma-9B and xLSTM-1.3B in the port against the
reference on the CPU, at their reduced configs in fp32.

The reference differentiates its scans with JAX (the RG-LRU's
``associative_scan``, mLSTM's parallel and chunkwise forms, the sLSTM
loop's ``lax.scan``); the port differentiates its plain PyTorch with
autograd. Here: ``loss_fn`` and every gradient leaf against
``jax.value_and_grad`` of the reference's, then two of the reference's
smoke-test steps (``tests/test_models_smoke.py``: AdamW at LR 1e-3); and
the gradients where the two could part: the sLSTM stabilizer's maximum
at a tie from its initial ``m = -30`` state and the normalizer at its
floor (``torch.maximum`` splits a tie as ``jnp.maximum`` does), the
RG-LRU input gate's clip at both bounds (``jnp.clip`` halves the gradient
there, ``torch.clamp`` would not), and mLSTM's ``-inf`` masks and
``maximum(|.|, exp(-m))`` denominators with rows whose |sum| is 0 (zero,
never NaN, gradients).

Tolerances, fp32 on both sides: the loss within 1e-5 relative, each
gradient leaf within 1e-5 of its own largest |value| (a single function's
gradients within 1e-5 of theirs). sLSTM's input-gate bias ``b_i`` has a
zero gradient in exact arithmetic (``test_torch_recurrent.py``), so both
packages' values are rounding noise: both must lie below 1e-6 of the
model's largest gradient. After two AdamW steps (eps 1e-6 on both sides,
as ``test_torch_whisper_train.py`` explains) the bounds of
``test_torch_qwen3.py``'s 12-step run: each leaf's difference within 1e-4
of how far it moved (L2 norms), every element within 1.5e-4; ``b_i``,
stepped by AdamW on noise, to the element bound alone.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.optim import adamw as JAW  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import rglru as PRG  # noqa: E402
from repro_torch.models import ssm as PSSM  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim import adamw as PAW  # noqa: E402

LOSS_TOL = GRAD_TOL = FN_TOL = 1e-5
NOISE_TOL = 1e-6
MOVED_TOL, ELEM_TOL = 1e-4, 1.5e-4  # test_torch_qwen3.py's 12-step bounds
LR, ADAM_EPS = 1e-3, 1e-6


def _jcfg(arch):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _is_noise_leaf(cfg, name: str) -> bool:
    """sLSTM's ``b_i``: zero gradient in exact arithmetic."""
    layer = int(name.split(".")[1]) if name.startswith("layers.") else -1
    return name.endswith("mix.b_i") and cfg.block_kind(layer) == "slstm"


# RecurrentGemma over a prompt longer than its window of 64 (the ring of
# its local attention); xLSTM at the smoke test's 16 tokens, its chunk (the
# parallel form) and at 48 (chunkwise)
CASES = [pytest.param("recurrentgemma-9b", 80, id="recurrentgemma-s80"),
         pytest.param("xlstm-1.3b", 16, id="xlstm-s16-parallel"),
         pytest.param("xlstm-1.3b", 48, id="xlstm-s48-chunkwise")]


@pytest.mark.parametrize("arch,S", CASES)
def test_loss_grads_and_two_adamw_steps_match_reference(arch, S):
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: JR.init_params(k, jcfg))(
        jax.random.PRNGKey(5)))
    rng = np.random.default_rng(6)
    labels = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    labels[:, :S // 4] = -1
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32),
             "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtc = JaxTrainConfig(total_steps=10, inner_lr=LR, adam_eps=ADAM_EPS)

    def grad_fn(p):
        return jax.value_and_grad(lambda q: JR.loss_fn(q, jcfg, jb), has_aux=True)(p)

    @jax.jit
    def step(p, s):
        (loss, _), g = grad_fn(p)
        p, s = JAW.adamw_update(g, s, p, jtc, jnp.float32(LR))
        return p, s, loss, g

    jp = jax.tree.map(jnp.asarray, tree)
    js = JAW.adamw_init(jp, jtc)
    jlosses, jgrads = [], None
    for _ in range(2):
        jp, js, jl, jg = step(jp, js)
        jlosses.append(float(jl))
        jgrads = jgrads or _leaves_np(jg)
    tc = pt_config.TrainConfig(total_steps=10, inner_lr=LR, adam_eps=ADAM_EPS)
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    leaves = param_leaves(params)
    state = PAW.adamw_init(leaves, tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for i in range(2):
        loss, _ = PR.loss_fn(params, cfg, tb)
        loss.backward()
        if i == 0:  # the first step's gradients, every leaf
            assert len(leaves) == len(jgrads)
            top = max(float(np.abs(g).max()) for g in jgrads)
            for (name, t), g in zip(leaves, jgrads):
                got = t.grad.numpy()
                assert got.shape == g.shape and np.isfinite(got).all(), name
                if _is_noise_leaf(cfg, name):
                    assert max(np.abs(g).max(), np.abs(got).max()) <= NOISE_TOL * top, name
                else:
                    assert _err(got, g) <= GRAD_TOL, name
        PAW.adamw_update([t.grad for _, t in leaves], state, leaves, tc, LR)
        for _, t in leaves:
            t.grad = None
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    for (name, t), x, x0 in zip(leaves, _leaves_np(jp), _leaves_np(tree)):
        d = t.detach().numpy() - x
        assert np.abs(d).max() <= ELEM_TOL, name
        if not _is_noise_leaf(cfg, name):
            assert np.linalg.norm(d) <= MOVED_TOL * np.linalg.norm(x - x0), name
    kinds = {cfg.block_kind(i) for i in range(cfg.num_layers)}
    assert kinds == ({"rglru", "local_attn"} if arch.startswith("recurrent")
                     else {"mlstm", "slstm"})


def _slstm_params(jcfg):
    return JSSM.init_slstm(jax.random.PRNGKey(1), jcfg)


@pytest.mark.parametrize("case", ["stabilizer-tie-at-m-30", "normalizer-at-its-floor",
                                  "first-step-from-the-initial-state"])
def test_slstm_step_gradient_at_ties_matches_reference(case):
    """The gradient of one sLSTM step (every output weighted) with respect
    to its inputs, its state and its recurrent weights, against
    ``jax.grad`` of the reference's ``slstm_cell``:

    - the stabilizer's tie: from the initial state (``m = -30``), a forget
      gate of 200 (log sigmoid exactly 0) and an input gate of exactly -30,
      so ``max(log_f + m, i)`` has equal arguments;
    - the normalizer at its floor: ``n = 1e-6``, an input gate of -200
      (its share underflows to 0) and the same forget gate, so ``n_new``
      is the floor exactly;
    - a first step from the initial state with random gates."""
    jcfg = _jcfg("xlstm-1.3b")
    cfg = _port_cfg(jcfg)
    jp = _slstm_params(jcfg)
    pp = {k: _t(v) for k, v in jp.items()}
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((2, H, dh)).astype(np.float32) for _ in range(4)]
    c, n = np.zeros((2, H, dh), np.float32), np.zeros((2, H, dh), np.float32)
    m = np.full((2, H, dh), -30.0, np.float32)
    h = np.zeros((2, H, dh), np.float32)
    if case != "first-step-from-the-initial-state":
        xs[1][:] = 200.0  # forget gate: log_sigmoid exactly 0
        if case == "stabilizer-tie-at-m-30":
            xs[0][:] = -30.0
        else:
            xs[0][:] = -200.0
            n[:] = np.float32(1e-6)
            m[:] = 0.0
            c = rng.standard_normal((2, H, dh)).astype(np.float32)
    w = [rng.standard_normal((2, H, dh)).astype(np.float32) for _ in range(5)]
    ins = [*xs, c, n, m, h]

    def jf(p, xi, xf, xz, xo, c, n, m, h):
        (c1, n1, m1, h1), _ = JSSM.slstm_cell(p, jcfg, (c, n, m, h), xi, xf, xz, xo)
        return sum(jnp.sum(a * b) for a, b in zip((c1, n1, m1, h1, h1 * h1), w))

    jgrads = jax.grad(jf, argnums=tuple(range(9)))(jp, *[jnp.asarray(a) for a in ins])
    pins = [_t(a, grad=True) for a in ins]
    for v in pp.values():
        v.requires_grad_(True)
    (c1, n1, m1, h1), _ = PSSM.slstm_cell(pp, cfg, tuple(pins[4:]), *pins[:4])
    sum((a * _t(b)).sum() for a, b in zip((c1, n1, m1, h1, h1 * h1), w)).backward()
    if case == "stabilizer-tie-at-m-30":
        assert torch.equal(m1, torch.full_like(m1, -30.0))
    if case == "normalizer-at-its-floor":
        assert torch.equal(n1, torch.full_like(n1, np.float32(1e-6)))
    for name, t in zip(("xi", "xf", "xz", "xo", "c", "n", "m", "h"), pins):
        assert np.isfinite(t.grad.numpy()).all(), name
        assert _err(t.grad.numpy(), jgrads[1 + ("xi", "xf", "xz", "xo", "c", "n", "m",
                                                     "h").index(name)]) <= FN_TOL, name
    for k in ("r_i", "r_f", "r_z", "r_o"):
        assert _err(pp[k].grad.numpy(), jgrads[0][k]) <= FN_TOL, k


def test_rglru_clip_halves_the_gradient_at_its_bounds_as_jnp_clip():
    """``_clip`` against ``jnp.clip`` at the RG-LRU's bounds (1e-6 and 1),
    inside, below and above them: the same values and gradients (half at a
    bound); then ``_rglru_gates`` where, in half the channels, 1 - a^2
    rounds to 1 with a^2 still above 0 (the upper bound, with a gradient
    through a^2), its gated input's gradient with respect to every gate
    parameter against the reference's, those channels' Lambda on their own
    scale too."""
    lo = 1.0 / PRG._MAX_SQRT_GRADIENT ** 2
    x = np.array([lo, 1.0, 0.5, lo / 2, 2.0, 1e-3], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.sqrt(jnp.clip(a, lo, 1.0))))(jnp.asarray(x))
    t = _t(x, grad=True)
    y = PRG._clip(t, lo, 1.0)
    assert np.array_equal(y.detach().numpy(), np.clip(x, np.float32(lo), np.float32(1.0)))
    torch.sqrt(y).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    assert t.grad[1] == pytest.approx(0.25) and t.grad[4] == 0.0

    jcfg = _jcfg("recurrentgemma-9b")
    W = jcfg.resolved_lru_width
    rng = np.random.default_rng(12)
    p = {"w_a": rng.standard_normal((W, W)).astype(np.float32) * 0.01,
         "b_a": rng.standard_normal(W).astype(np.float32),
         "w_i": rng.standard_normal((W, W)).astype(np.float32) * 0.1,
         "b_i": rng.standard_normal(W).astype(np.float32),
         "lambda": np.full(W, 3.0, np.float32)}
    # in the upper half log a = -8 softplus(3) r, r = sigmoid(2 + ...) near 1:
    # a^2 between about 1e-20 and 1e-12, so 1 - a^2 is 1 in fp32
    p["b_a"][W // 2:] = 2.0
    p["lambda"][: W // 2] = rng.standard_normal(W // 2).astype(np.float32)
    u = rng.standard_normal((2, 9, W)).astype(np.float32)

    def jf(p, u):
        return jnp.sum(JRG._rglru_gates(p, u)[1] * wts)

    wts = rng.standard_normal((2, 9, W)).astype(np.float32)
    jgrads = jax.grad(jf, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(u))
    pp = {k: _t(v, grad=True) for k, v in p.items()}
    pu = _t(u, grad=True)
    log_a, gated = PRG._rglru_gates(pp, pu)
    a2 = torch.exp(2 * log_a[..., W // 2:])
    assert bool(((1.0 - a2) == 1.0).all() and (a2 > 0).all())  # at the upper bound
    (gated * _t(wts)).sum().backward()
    for k in p:
        assert _err(pp[k].grad.numpy(), jgrads[0][k]) <= FN_TOL, k
    assert _err(pu.grad.numpy(), jgrads[1]) <= FN_TOL
    # the channels at the bound, on their own scale: half the unclipped
    # gradient, as the reference's (torch.clamp would give all of it)
    upper = pp["lambda"].grad[W // 2:].numpy()
    assert np.abs(upper).max() > 0
    assert _err(upper, np.asarray(jgrads[0]["lambda"])[W // 2:]) <= FN_TOL


@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_gradients_with_zero_rows_and_masks_match_reference(form):
    """mLSTM's two sequence forms with a query row of zeros (its |sum| is 0,
    where ``abs`` has its kink, and the denominator takes exp(-m)) and the
    causal ``-inf`` masks: every input's gradient finite (zero, not NaN,
    where a mask cuts) and within 1e-5 of the reference's."""
    rng = np.random.default_rng(13)
    B, S, H, dh = 2, 32, 3, 8
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3))
    q[:, 5] = 0.0
    q[1, 17, 2] = 0.0
    ig = (rng.standard_normal((B, S, H)) * 2).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) * 2 + 2).astype(np.float32)
    wts = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    ins = (q, k, v, ig, fg)

    def run_j(*a):
        fn = JSSM.mlstm_parallel if form == "parallel" else (
            lambda *b: JSSM.mlstm_chunkwise(*b, chunk=8))
        return jnp.sum(fn(*a) * wts)

    jgrads = jax.grad(run_j, argnums=tuple(range(5)))(*[jnp.asarray(a) for a in ins])
    pins = [_t(a, grad=True) for a in ins]
    out = (PSSM.mlstm_parallel(*pins) if form == "parallel"
           else PSSM.mlstm_chunkwise(*pins, chunk=8))
    (out * _t(wts)).sum().backward()
    for name, t, g in zip(("q", "k", "v", "ig", "fg"), pins, jgrads):
        assert np.isfinite(t.grad.numpy()).all(), name
        assert _err(t.grad.numpy(), g) <= FN_TOL, name
    # the last position's key and value reach no earlier query: only its own
    assert np.isfinite(pins[1].grad[:, -1].numpy()).all()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_by_slices_equals_the_whole_leaf_update(monkeypatch, state_dtype):
    """``adamw_update`` takes a contiguous leaf ``UPDATE_SLICE`` values at a
    time (RecurrentGemma-9B's 256 000-row tables on the card; every leaf of
    the reduced config is one slice): with the slice cut to 1 000 values,
    three steps over every leaf of the reduced RecurrentGemma give the bits
    of the whole-leaf update, parameters and moments, fp32 and bf16
    moments alike."""
    jcfg = _jcfg("recurrentgemma-9b")
    cfg = _port_cfg(jcfg)
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: JR.init_params(k, jcfg))(
        jax.random.PRNGKey(7)))
    tc = pt_config.TrainConfig(opt_state_dtype=state_dtype)
    sides = []
    for slice_ in (PAW.UPDATE_SLICE, 1000):
        monkeypatch.setattr(PAW, "UPDATE_SLICE", slice_)
        leaves = param_leaves(params_from_jax(tree, cfg, device="cpu", training=True))
        state = PAW.adamw_init(leaves, tc)
        rng = np.random.default_rng(8)
        for step in range(3):
            grads = [torch.from_numpy((rng.standard_normal(t.shape) * 0.01).astype(np.float32))
                     for _, t in leaves]
            PAW.adamw_update(grads, state, leaves, tc, 1e-3)
        sides.append((leaves, state))
    (la, sa), (lb, sb) = sides
    assert max(t.numel() for _, t in la) > 1000  # some leaves were sliced
    for (name, a), (_, b) in zip(la, lb):
        assert torch.equal(a, b), name
    for xs, ys in ((sa.mu, sb.mu), (sa.nu, sb.nu)):
        for x, y in zip(xs, ys):
            assert x.dtype == getattr(torch, state_dtype) and torch.equal(x, y)


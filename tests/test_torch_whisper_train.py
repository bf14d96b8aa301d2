"""Training Whisper-large-v3 (encoder-decoder) in the port against the
reference on the CPU, at its reduced config in fp32 (2 encoder and 2
decoder layers, d_model 256, 4 heads of hd 64, 64 frames).

The reference trains Whisper through ``loss_fn`` and its gradient on a
batch that carries frames, followed by an AdamW step
(``tests/test_models_smoke.py``); its simulator's and its Trainer's
batches carry no frames. So here: ``loss_fn`` with frames and every
gradient leaf against ``jax.value_and_grad`` of the reference's, two of
the smoke test's steps (AdamW at LR 1e-3) against the reference's; the
plain flash attention's gradient over keys of another length than the
queries against ``jax.vjp`` of the reference's attention; ``decay_mask``
on every leaf of Whisper, RecurrentGemma-9B and xLSTM-1.3B; the
simulator and the Trainer's launcher refusing Whisper with the no-frames
message; and, with the kernel library replaced by a recorder, the flash
backward's C entry points taking the key length on every route and the
bf16 backward at RecurrentGemma's hd 256 on the CUDA cores.

Tolerances, fp32 on both sides: the loss within 1e-5 relative; each
gradient leaf within 1e-5 of its own largest |value|; after two AdamW
steps the bounds of ``test_torch_qwen3.py``'s 12-step run, each leaf's
difference within 1e-4 of how far it moved (L2 norms) and every element
within 1.5e-4, at AdamW eps 1e-6 on both sides as in the MoE runs
(``test_torch_moe_sim.py``): the normalized step g / (|g| + eps) turns a
rounding difference in a gradient element near eps into a visible one,
and at the default 1e-8 the first decoder layer's ``w_down`` differed by
1.35e-4 of its movement (2.9e-5 at 1e-6); the attention's gradients
within 1e-5 of their largest |value|.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as JAW  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch.optim import adamw as PAW  # noqa: E402

LOSS_TOL = GRAD_TOL = ATTN_TOL = 1e-5
MOVED_TOL, ELEM_TOL = 1e-4, 1.5e-4  # test_torch_qwen3.py's 12-step bounds
LR = 1e-3  # the smoke test's
ADAM_EPS = 1e-6


def _jcfg(arch="whisper-large-v3"):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _leaf_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(jcfg, seed=3, B=2, S=16):
    """Tokens, labels with a fifth masked, and frames, as numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    return {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels,
            "frames": rng.standard_normal((B, jcfg.encoder_seq_len, jcfg.d_model)).astype(
                np.float32)}


def _reference(jcfg, seed=0):
    """The reference's parameters (jitted init) as numpy."""
    return jax.tree.map(np.asarray, jax.jit(lambda k: JR.init_params(k, jcfg))(
        jax.random.PRNGKey(seed)))


def test_loss_and_every_gradient_leaf_with_frames_match_reference():
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _reference(jcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JR.loss_fn(p, jcfg, jb), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    loss, m = PR.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert float(m["tokens"]) == float(jm["tokens"]) == float((batch["labels"] >= 0).sum())
    leaves = param_leaves(params)
    jleaves = _leaves_np(jg)
    assert len(leaves) == len(jleaves)
    names = [n for n, _ in leaves]
    # the encoder's subtree, its positions and each layer's cross sub-block
    # all get a gradient
    for name in ("encoder.positions", "encoder.layers.1.mix.wq", "encoder.final_norm.bias",
                 "layers.0.cross.wk", "layers.1.norm_cross.scale", "embed.positions"):
        assert name in names, name
    for (name, t), g in zip(leaves, jleaves):
        assert t.grad is not None and t.grad.shape == g.shape, name
        assert np.isfinite(t.grad.numpy()).all(), name
        assert _leaf_err(t.grad.numpy(), g) <= GRAD_TOL, name
    for name in ("encoder.positions", "layers.0.cross.wk"):
        assert float(dict(leaves)[name].grad.abs().max()) > 0, name


def test_two_adamw_steps_match_the_reference_smoke_step():
    """The reference's smoke step (``value_and_grad`` of ``loss_fn`` with
    frames, then ``adamw_update`` at LR 1e-3; eps 1e-6, the module
    docstring) twice on the same batch: both losses and every parameter
    after them."""
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _reference(jcfg, seed=1)
    batch = _batch(jcfg, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtc = JaxTrainConfig(total_steps=10, inner_lr=LR, adam_eps=ADAM_EPS)

    @jax.jit
    def step(p, s):
        (loss, _), g = jax.value_and_grad(lambda q: JR.loss_fn(q, jcfg, jb), has_aux=True)(p)
        p, s = JAW.adamw_update(g, s, p, jtc, jnp.float32(LR))
        return p, s, loss

    jp = jax.tree.map(jnp.asarray, tree)
    js = JAW.adamw_init(jp, jtc)
    jlosses = []
    for _ in range(2):
        jp, js, jl = step(jp, js)
        jlosses.append(float(jl))
    tc = pt_config.TrainConfig(total_steps=10, inner_lr=LR, adam_eps=ADAM_EPS)
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    leaves = param_leaves(params)
    state = PAW.adamw_init(leaves, tc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        loss, _ = PR.loss_fn(params, cfg, tb)
        loss.backward()
        PAW.adamw_update([t.grad for _, t in leaves], state, leaves, tc, LR)
        for _, t in leaves:
            t.grad = None
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    assert losses[1] < losses[0]
    for (name, t), x, x0 in zip(leaves, _leaves_np(jp), _leaves_np(tree)):
        d = t.detach().numpy() - x
        assert np.abs(d).max() <= ELEM_TOL, name
        assert np.linalg.norm(d) <= MOVED_TOL * np.linalg.norm(x - x0), name
    moved = [n for (n, t), x0 in zip(leaves, _leaves_np(tree))
             if np.abs(t.detach().numpy() - x0).max() > 0]
    assert "encoder.positions" in moved and "layers.1.cross.wo" in moved


@pytest.mark.parametrize("Sq,Skv,H,Hkv", [(16, 64, 4, 4), (7, 100, 4, 2), (1, 33, 2, 1),
                                          (80, 24, 4, 2)])
def test_plain_flash_gradient_over_keys_of_another_length_matches_jax_vjp(Sq, Skv, H, Hkv):
    """The plain flash version's gradient (autograd, the CPU route of
    ``FlashAttentionFn``'s backward) at Skv != S, no mask, against
    ``jax.vjp`` of the reference's ``gqa_attention`` at ``q_positions =
    Skv``; and the plain backward (``flash_attention_bwd_ref``, the
    kernels' algebra) against both."""
    hd = 64
    rng = np.random.default_rng(Sq + 7 * Skv + H)
    q, do = (rng.standard_normal((2, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, Skv, Hkv, hd)).astype(np.float32) for _ in range(2))

    def ref(q, k, v):
        return JA.gqa_attention(q, k, v, q_positions=jnp.full((Sq,), Skv, jnp.int32),
                                kv_positions=jnp.arange(Skv, dtype=jnp.int32), causal=False)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = R.flash_attention_ref(*ts, causal=False)
    out.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        assert t.grad.shape == w.shape
        assert _leaf_err(t.grad.numpy(), w) <= ATTN_TOL
    o, lse = R.flash_attention_fwd_ref(*(t.detach() for t in ts), causal=False)
    assert lse.shape == (2, H, Sq)
    algebra = R.flash_attention_bwd_ref(*(t.detach() for t in ts), o, lse,
                                        torch.from_numpy(do), causal=False)
    for g, w in zip(algebra, want):
        assert _leaf_err(g.numpy(), w) <= ATTN_TOL


@pytest.mark.parametrize("arch", ["whisper-large-v3", "recurrentgemma-9b", "xlstm-1.3b"])
def test_decay_mask_matches_reference_on_every_leaf(arch):
    """``decay_mask`` against the reference's ``_decay_mask`` on every leaf
    of the reduced model: Whisper's ``positions`` (both), LayerNorm
    ``bias``, ``norm_cross``; RG-LRU's ``lambda``, ``conv``, ``b_*``;
    mLSTM's ``b_igate`` / ``out_norm``; sLSTM's ``r_*`` and ``b_*``."""
    jcfg = _jcfg(arch)
    tree = _reference(jcfg)
    flags = []

    def record(path, x):
        flags.append(JAW._decay_mask(path))
        return x

    jax.tree_util.tree_map_with_path(record, tree)
    params = params_from_jax(tree, _port_cfg(jcfg), device="cpu", training=True)
    names = [n for n, _ in param_leaves(params)]
    assert [PAW.decay_mask(n) for n in names] == flags
    last = {n.rsplit(".", 1)[-1] for n in names}
    seen = {"whisper-large-v3": {"positions", "bias", "scale"},
            "recurrentgemma-9b": {"lambda", "conv", "b_a", "b_i"},
            "xlstm-1.3b": {"r_i", "b_f", "out_norm", "b_igate", "conv"}}[arch]
    assert seen <= last


def test_simulated_run_and_the_trainer_refuse_whisper_for_want_of_frames():
    """The simulator's ``MarkovLM`` batches and the Trainer's synthetic
    pipeline hold tokens and labels only: an encoder-decoder is refused up
    front, naming the missing frames (the reference fails on the missing
    key); a model with recurrent blocks is accepted by both."""
    cfg = pt_configs.get_reduced_config("whisper-large-v3")
    tc = pt_config.TrainConfig(total_steps=4, global_batch_size=2, seq_len=8)
    with pytest.raises(ValueError, match="MarkovLM batches carry no \"frames\""):
        SimulatedRun(cfg, tc, num_groups=1, device="cpu")
    with pytest.raises(ValueError, match="synthetic pipeline's batches carry no \"frames\""):
        LT.configs_from_args(LT.build_parser().parse_args(
            ["--reduced", "--arch", "whisper-large-v3"]))
    with pytest.raises(ValueError, match="loss_fn"):
        SimulatedRun(cfg, tc, num_groups=1, device="cpu")
    mc, _, _ = LT.configs_from_args(LT.build_parser().parse_args(
        ["--reduced", "--arch", "xlstm-1.3b"]))
    assert mc.name == "xlstm-1.3b-reduced"


class _Recorder:
    """Stands in for the kernel library: records each entry point's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in _build.SIGNATURES:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


# (dtype, hd, B, S, Skv, H, Hkv, causal, window, tensor-core backward)
BWD_ROUTES = [
    pytest.param("bfloat16", 64, 2, 448, 1500, 20, 20, False, 0, True, id="whisper-cross"),
    pytest.param("bfloat16", 64, 2, 1500, 1500, 20, 20, False, 0, True, id="whisper-encoder"),
    pytest.param("float32", 64, 2, 64, 1500, 20, 20, False, 0, False, id="cross-fp32"),
    pytest.param("bfloat16", 128, 1, 77, 300, 8, 4, False, 0, True, id="cross-hd128"),
    pytest.param("bfloat16", 256, 1, 77, 300, 8, 4, False, 0, False, id="cross-hd256"),
    pytest.param("bfloat16", 256, 2, 1024, 1024, 16, 1, True, 2048, False,
                 id="recurrentgemma-hd256"),
]


@pytest.mark.parametrize("dtype,hd,B,S,Skv,H,Hkv,causal,window,tc", BWD_ROUTES)
def test_backward_routes_take_the_key_length(monkeypatch, dtype, hd, B, S, Skv, H, Hkv,
                                             causal, window, tc):
    """With the library replaced by a recorder, the flash backward launched
    through ``FlashAttentionFn`` goes to the tensor-core entry point for
    bf16 at hd 64 / 128 and to the CUDA-core one otherwise (bf16 at hd 256,
    RecurrentGemma's local attention, among them), each with ``Skv`` after
    head_dim and the mask and scale after it; ``cross_bwd_launches`` moves
    where Skv != S; the C entry points refuse a mask over keys of another
    length themselves too (their source's guard)."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name in ("launches", "bwd_launches", "tc_bwd_launches", "cross_launches",
                 "cross_bwd_launches"):
        monkeypatch.setattr(FK, name, 0)
    dt = getattr(torch, dtype)
    q = torch.zeros((B, S, H, hd), dtype=dt, requires_grad=True)
    k, v = (torch.zeros((B, Skv, Hkv, hd), dtype=dt, requires_grad=True) for _ in range(2))
    FK.FlashAttentionFn.apply(q, k, v, causal, window, 0.0).backward(torch.zeros_like(q))
    assert FK.tensor_core_bwd_route(q) is tc
    name, args = rec.calls[-1]
    assert name == "flash_attention_bwd" + ("_tc_launch" if tc else "_launch")
    assert len(args) == len(_build.SIGNATURES[name])
    head = list(args[9:15]) if tc else [args[10], *args[11:17]]
    want = [B, S, H, Hkv, hd, Skv]
    assert head == (want if tc else [_build.DTYPE_CODES[dt], *want])
    assert args[-6:-3] == (int(causal), window, 0.0)
    assert args[-3] == pytest.approx(1.0 / math.sqrt(hd))
    assert (FK.bwd_launches, FK.tc_bwd_launches, FK.cross_bwd_launches) == (
        1, int(tc), int(Skv != S))
    assert q.grad.shape == q.shape and k.grad.shape == k.shape == (B, Skv, Hkv, hd)
    src = (_build.CSRC / ("flash_attention_bwd_tc.cu" if tc else "flash_attention_bwd.cu"))
    assert "if (Skv < 1 || (Skv != S && (causal || window > 0)))" in src.read_text()

"""Whisper-large-v3 (encoder-decoder) and Chameleon-34B against the reference
on the CPU, at their reduced configs in fp32 (Whisper: 2 encoder and 2
decoder layers, d_model 256, 4 heads of hd 64, 64 frames).

The plain flash attention with keys of another length than the queries
(cross-attention, no mask) against the reference's ``gqa_attention`` at
``q_positions = Skv``; ``encode``; ``forward`` and ``loss_fn`` with frames;
``prefill`` and 8 teacher-forced ``decode_step``s against the reference's,
the cross cache read through the paged decode's pool view; both config
copies field by field; the simulator refusing Whisper (its token batches
carry no frames; Whisper trains through ``loss_fn``,
``test_torch_whisper_train.py``). Logits and outputs
within 1e-5 of the reference's largest |value| (1e-6 for the attention
alone), losses 1e-5 relative. Serving through ``generate`` and the
launcher, the parameter conversion and Chameleon's paged path are in
``test_torch_whisper_serve.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

TOL = 1e-5
ATTN_TOL = 1e-6
ARCHS = ("whisper-large-v3", "chameleon-34b")
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _jcfg(arch="whisper-large-v3", **kw):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0, gain=1.0):
    """Reference parameters as numpy, the matmul weights times ``gain``."""
    params = jax.jit(lambda k: JR.init_params(k, jcfg))(jax.random.PRNGKey(seed))

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x, np.float32) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frames(jcfg, B, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
def test_config_copy_equals_reference(arch, get):
    jc, pc = getattr(jax_configs, get)(arch), getattr(pt_configs, get)(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc), (arch, get)
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert arch in pt_configs.list_architectures()


def test_encoder_decoder_fields_equal_reference():
    """The encoder-decoder fields and every other one, field by field with
    their defaults, as the reference's ``ModelConfig`` has them."""
    from repro import config as jax_config

    jf = {f.name: f for f in dataclasses.fields(jax_config.ModelConfig)}
    pf = {f.name: f for f in dataclasses.fields(pt_config.ModelConfig)}
    assert list(pf) == list(jf)
    for name in ("is_encoder_decoder", "encoder_layers", "encoder_seq_len"):
        assert pf[name].default == jf[name].default and pf[name].type == jf[name].type
    full = pt_configs.get_config("whisper-large-v3")
    assert (full.is_encoder_decoder, full.encoder_layers, full.encoder_seq_len,
            full.num_layers, full.d_model, full.resolved_head_dim) == (
        True, 32, 1500, 32, 1280, 64)


@pytest.mark.parametrize("Sq", [1, 7, 64])
@pytest.mark.parametrize("Skv", [64, 100])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_plain_cross_attention_matches_reference(Sq, Skv, H, Hkv):
    """Keys of another length than the queries, no mask: every query sees
    every key, as the reference's ``gqa_attention`` at ``q_positions =
    Skv``; through the wrapper's CPU route too."""
    hd = 64
    rng = np.random.default_rng(Sq * 1000 + Skv + H + Hkv)
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, Skv, Hkv, hd)).astype(np.float32)
    ref = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_positions=jnp.full((Sq,), Skv, jnp.int32),
                           kv_positions=jnp.arange(Skv, dtype=jnp.int32), causal=False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = R.flash_attention_ref(tq, tk, tv, causal=False)
    assert got.shape == (2, Sq, H, hd)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= ATTN_TOL
    assert torch.equal(kops.flash_attention(tq, tk, tv, causal=False), got)
    if Sq != Skv:
        for kw in (dict(causal=True), dict(causal=False, window=16)):
            with pytest.raises(ValueError, match="keys of length"):
                R.flash_attention_ref(tq, tk, tv, **kw)
            with pytest.raises(ValueError, match="keys of length"):
                kops.flash_attention(tq, tk, tv, **kw)


def test_encode_matches_reference():
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, gain=3.0)
    frames = _frames(jcfg, 2)
    ref = jax.jit(lambda p, f: JT.encode(p, jcfg, f))(jax.tree.map(jnp.asarray, tree),
                                                       jnp.asarray(frames))
    params = params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        got = PT.encode(params, cfg, torch.from_numpy(frames))
    assert got.shape == (2, jcfg.encoder_seq_len, jcfg.d_model)
    assert _rel_err(got.numpy(), ref) <= TOL
    # fewer frames than encoder_seq_len: the positions are sliced
    short = jax.jit(lambda p, f: JT.encode(p, jcfg, f))(jax.tree.map(jnp.asarray, tree),
                                                         jnp.asarray(frames[:, :40]))
    with torch.no_grad():
        got = PT.encode(params, cfg, torch.from_numpy(frames[:, :40]))
    assert _rel_err(got.numpy(), short) <= TOL


def test_forward_and_loss_with_frames_match_reference():
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=1, gain=3.0)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.where(rng.random((2, 16)) < 0.2, -1,
                      rng.integers(0, jcfg.vocab_size, (2, 16))).astype(np.int32)
    batch = {"tokens": toks, "labels": labels, "frames": _frames(jcfg, 2)}

    def ref(p, b):
        return JR.forward(p, jcfg, b)[0], JR.loss_fn(p, jcfg, b)[0]

    jl, jloss = jax.jit(ref)(jax.tree.map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = PR.forward(params, cfg, tb)
        loss, m = PR.loss_fn(params, cfg, tb)
    assert _rel_err(logits.numpy(), jl) <= TOL
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(aux["moe_aux"]) == 0.0
    # the frames change the logits: the cross-attention is live
    tb2 = dict(tb, frames=tb["frames"] * 2)
    with torch.no_grad():
        assert not torch.allclose(PR.forward(params, cfg, tb2)[0], logits)
    with pytest.raises(ValueError, match="frames"):
        PR.forward(params, cfg, {"tokens": tb["tokens"]})


@pytest.mark.parametrize("S", [12, 1])
def test_prefill_and_decode_steps_match_reference(S):
    """A prefill of S tokens over 64 frames, then 8 teacher-forced decode
    steps: every step's logits against the reference's (which reads its
    cross K/V from ``state["cross_kv"]``); the port's cross caches hold the
    reference's K/V, padded to 64 rows (a multiple of the pool view's
    block) with zeros past them."""
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=2, gain=3.0)
    D, max_len = 8, 24
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, S + D)).astype(np.int32)
    frames = _frames(jcfg, 2, seed=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jst = jax.jit(lambda p, t, f: JR.prefill(p, jcfg, {"tokens": t, "frames": f},
                                                 max_len=max_len))(
        jparams, jnp.asarray(toks[:, :S]), jnp.asarray(frames))
    jstep = jax.jit(lambda p, s, t: JR.decode_step(p, jcfg, s, t))
    ref = [np.asarray(jl[:, -1])]
    for t in range(D):
        jl, jst = jstep(jparams, jst, jnp.asarray(toks[:, S + t:S + t + 1]))
        ref.append(np.asarray(jl[:, 0]))
    params = params_from_jax(tree, cfg, device="cpu")
    pt = torch.from_numpy(toks)
    with torch.no_grad():
        pl, pst = PR.prefill(params, cfg, {"tokens": pt[:, :S],
                                           "frames": torch.from_numpy(frames)},
                             max_len=max_len)
        got = [pl[:, -1].numpy()]
        for t in range(D):
            pl, pst = PR.decode_step(params, cfg, pst, pt[:, S + t:S + t + 1])
            got.append(pl[:, 0].numpy())
    ref, got = np.stack(ref, 1), np.stack(got, 1)
    assert got.shape == (2, D + 1, jcfg.vocab_size) and np.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL
    assert pst["position"] == S + D
    Skv = jcfg.encoder_seq_len
    for cache, (jk, jv) in zip(pst["cross_kv"], jst["cross_kv"]):
        assert cache["k"].shape == (2, 64, jcfg.num_kv_heads, 64) and cache["k"].is_contiguous()
        assert cache["tables"].tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert cache["context"].tolist() == [Skv, Skv]
        assert _rel_err(cache["k"][:, :Skv].numpy(), jk) <= TOL
        assert _rel_err(cache["v"][:, :Skv].numpy(), jv) <= TOL


def test_cross_cache_pads_to_the_pool_view():
    """1 500 frames give 1 504 rows (94 blocks of 16), the last 4 zeros past
    the context; the decode route over the view equals the plain attention
    over the 1 500 keys."""
    cfg = _port_cfg(_jcfg(encoder_seq_len=1500))
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.standard_normal((2, 1500, 4, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 1500, 4, 64)).astype(np.float32))
    cache = PA.cross_cache_from_kv(cfg, k, v)
    assert cache["k"].shape == (2, 1504, 4, 64) and cache["k"].is_contiguous()
    assert cache["tables"].shape == (2, 94) and cache["context"].tolist() == [1500, 1500]
    assert not cache["k"][:, 1500:].any() and not cache["v"][:, 1500:].any()
    zero = PA.init_cross_cache(cfg, 3, device="cpu")
    assert zero["k"].shape == (3, 1504, 4, 64) and zero["context"].tolist() == [1500] * 3
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    out = kops.paged_decode_attention(q[:, 0], PA._block_view(cache["k"]),
                                      PA._block_view(cache["v"]), cache["tables"],
                                      cache["context"])
    ref = R.flash_attention_ref(q, k, v, causal=False)[:, 0]
    assert (out - ref).abs().max() <= ATTN_TOL


def test_check_trainable_refuses_whisper():
    """Whisper trains through ``loss_fn`` on a batch with frames
    (``test_torch_whisper_train.py``); the simulator's token batches carry
    none, so it refuses an encoder-decoder up front with that message, as
    ``check_token_batches`` does, and builds for Chameleon."""
    cfg = pt_configs.get_reduced_config("whisper-large-v3")
    PT.check_ported(cfg)  # it serves
    with pytest.raises(ValueError, match="MarkovLM batches carry no \"frames\""):
        PT.check_token_batches(cfg, "SimulatedRun", "MarkovLM")
    with pytest.raises(ValueError, match="MarkovLM batches carry no \"frames\""):
        SimulatedRun(cfg, TrainConfig(total_steps=4, global_batch_size=2, seq_len=8),
                     num_groups=1, device="cpu")
    PT.check_token_batches(pt_configs.get_reduced_config("chameleon-34b"), "SimulatedRun",
                           "MarkovLM")  # trains
    SimulatedRun(pt_configs.get_reduced_config("chameleon-34b"),
                 TrainConfig(total_steps=4, global_batch_size=2, seq_len=8), num_groups=1,
                 device="cpu")

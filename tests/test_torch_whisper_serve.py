"""Whisper-large-v3 served through the port's dense path on the CPU,
Chameleon-34B through the paged path, and the flash wrapper's forward with
keys of another length than the queries.

``generate``'s greedy tokens against the reference's dense ``generate``
over the same frames (reduced config, fp32); an encoder-decoder without
frames raises in ``generate`` and in the prefill step; the launcher on
the CPU; the parameter conversion of the encoder subtree and the cross
sub-blocks; Chameleon's reduced logits and greedy tokens against the
reference's forward (within 1e-5 of its largest |logit|); and, with the
kernel library replaced by a recorder, the
key length reaching the forward's and the backward's C entry points on
every route, and the ``cross_launches`` and ``cross_bwd_launches``
counters.
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
from repro.config import ParallelConfig  # noqa: E402
from repro.launch import mesh as M  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve.engine import generate as jax_generate  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import engine as PE  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FK  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.parallel.steps import build_serve_steps  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

TOL = 1e-5
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
COUNTERS = ("launches", "bwd_launches", "tc_launches", "tc_bwd_launches", "tc112_launches",
            "tc256_launches", "cross_launches", "cross_bwd_launches")


def _jcfg(arch="whisper-large-v3"):
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree(jcfg, seed=0, gain=1.0):
    params = jax.jit(lambda k: JR.init_params(k, jcfg))(jax.random.PRNGKey(seed))

    def scale(path, x):
        name = str(getattr(path[-1], "key", ""))
        return np.asarray(x, np.float32) * np.float32(gain if name in MATMUL_LEAVES else 1.0)

    return jax.tree_util.tree_map_with_path(scale, params)


def test_generate_greedy_matches_reference_dense_generate():
    """``generate`` takes the dense path, and its greedy tokens over the
    frames are the reference's dense ``generate``'s."""
    jcfg = _jcfg()
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jcfg))
    tree = _tree(jcfg, seed=1, gain=4.0)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    frames = np.random.default_rng(10).standard_normal(
        (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    mesh = M.small_mesh((1, 1), ("data", "model"))
    pc = ParallelConfig(data_axis_size=1, model_axis_size=1, data_outer=1)
    want, jinfo = jax_generate(jax.tree.map(jnp.asarray, tree), jcfg, pc, mesh, prompts, 8,
                               frames=jnp.asarray(frames))
    params = params_from_jax(tree, cfg, device="cpu")
    got, info = generate(params, cfg, prompts, 8, frames=torch.from_numpy(frames))
    assert jinfo["path"] == info["path"] == "dense"
    assert got.dtype == np.int32 and got.shape == (2, 8)
    assert got.tolist() == np.asarray(want).tolist()
    assert len(set(got[0].tolist())) > 1  # the tokens move
    # a numpy array of frames serves the same
    assert generate(params, cfg, prompts, 8, frames=frames)[0].tolist() == got.tolist()
    # other frames, other tokens: the decoder reads them
    assert generate(params, cfg, prompts, 8, frames=frames * 3)[0].tolist() != got.tolist()


def test_encoder_decoder_without_frames_raises():
    cfg = pt_config.ModelConfig(**dataclasses.asdict(_jcfg()))
    params = PR.init_params(cfg, seed=0, device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="needs frames"):
        generate(params, cfg, prompts, 2)
    bundle = build_serve_steps(cfg, batch=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        bundle.prefill_step(params, {"tokens": torch.zeros((2, 4), dtype=torch.int32)})
    frames = torch.zeros((1, cfg.encoder_seq_len, cfg.d_model))
    with pytest.raises(ValueError, match="frames"):  # one frame row for two prompts
        bundle.prefill_step(params, {"tokens": torch.zeros((2, 4), dtype=torch.int32),
                                     "frames": frames})


def test_launcher_serves_whisper_on_the_cpu(capsys):
    out, info = launch_serve.main(["--arch", "whisper-large-v3", "--reduced", "--device", "cpu",
                                   "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    assert out.shape == (2, 3) and info["path"] == "dense"
    said = capsys.readouterr().out
    assert "arch=whisper-large-v3-reduced path=dense device=cpu" in said
    assert "over 64 frames" in said
    again, _ = launch_serve.main(["--arch", "whisper-large-v3", "--reduced", "--device", "cpu",
                                  "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    assert np.array_equal(out, again)  # frames from the seed
    with pytest.raises(ValueError):  # the paged path's option
        launch_serve.main(["--arch", "whisper-large-v3", "--reduced", "--device", "cpu",
                           "--int8-kv"])


def test_params_from_jax_carries_the_encoder_and_cross_blocks():
    """Every reference leaf arrives under its pytree path (``encoder``
    subtree, ``norm_cross`` / ``cross``), in serving storage by name; the
    port's own ``init_params`` makes the same names and shapes, with no
    qk-norm on cross-attention."""
    jcfg = dataclasses.replace(jax_configs.get_reduced_config("whisper-large-v3"),
                               use_qk_norm=True)
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg)
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", ""))) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    params = params_from_jax(tree, cfg, device="cpu")
    leaves = PT.param_leaves(params)
    names = {n.replace(".", "/"): tuple(t.shape) for n, t in leaves}
    assert names == {k: tuple(v) for k, v in flat.items()}
    assert "encoder/positions" in names and "layers/1/cross/wq" in names
    assert "layers/0/norm_cross/bias" in names and "layers/0/mix/q_norm" in names
    assert not any("cross/q_norm" in n or "cross/k_norm" in n for n in names)
    stored = dict(leaves)
    assert stored["encoder.positions"].dtype == torch.bfloat16  # cast at use, as L.cast
    assert stored["encoder.layers.0.norm1.scale"].dtype == torch.float32
    mine = PT.param_leaves(PR.init_params(cfg, seed=0, device="cpu"))
    assert [(n, tuple(t.shape), t.dtype) for n, t in mine] == [
        (n, tuple(t.shape), t.dtype) for n, t in leaves]


def test_chameleon_paged_logits_match_reference():
    """Chameleon's reduced config (GQA 8 / 2, qk-norm, SwiGLU, untied) in
    fp32: the forward's logits against the reference's, and the paged
    engine's greedy tokens (a prefill, then decode steps over the pool)
    the argmax of the reference's forward."""
    jcfg = _jcfg("chameleon-34b")
    cfg = _port_cfg(jcfg)
    tree = _tree(jcfg, seed=5, gain=3.0)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 20)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t})[0])(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks)))
    params = params_from_jax(tree, cfg, device="cpu")
    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import PagedCacheConfig

    pcfg = PagedCacheConfig(num_blocks=8, block_size=4)
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cpu")
    eng = PE.ServeEngine(params, cfg, bundle, pcfg, PE.EngineConfig(
        max_slots=1, max_new_tokens=4, max_blocks_per_seq=7))
    assert "layers.0.mix.q_norm" in dict(PT.param_leaves(params))
    with torch.no_grad():
        got = PR.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0].numpy()
    assert _rel_err(got, ref) <= TOL
    # the engine's greedy tokens are the argmax of the reference's forward
    eng.submit(toks[0, :12], 4)
    out = eng.run()[0].tokens[:4]
    seq = np.concatenate([toks[0, :12], np.asarray(out[:3], np.int32)])[None]
    full = np.asarray(jax.jit(lambda p, t: JR.forward(p, jcfg, {"tokens": t})[0])(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(seq)))
    assert list(out) == full[0, 11:].argmax(-1).tolist()


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


@pytest.mark.parametrize("dtype,hd,tc", [("bfloat16", 64, True), ("float32", 64, False),
                                         ("bfloat16", 112, True), ("bfloat16", 128, True),
                                         ("bfloat16", 256, True), ("bfloat16", 40, False)])
def test_forward_passes_the_key_length_on_every_route(monkeypatch, dtype, hd, tc):
    """Each route's C entry point gets ``Skv`` after head_dim (so the
    older arguments keep their places), ``cross_launches`` counts the
    forwards whose Skv is not S; a forward whose gradient is needed runs
    through ``FlashAttentionFn``, whose backward passes ``Skv`` after
    head_dim to its route's entry point (bf16 at hd 64 / 128 the tensor
    cores) and moves ``cross_bwd_launches``; a causal Skv != S raises
    before any launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name in COUNTERS:
        monkeypatch.setattr(FK, name, 0)
    dt = getattr(torch, dtype)
    B, S, Skv, H, Hkv = 2, 33, 150, 4, 2
    q = torch.zeros((B, S, H, hd), dtype=dt)
    k, v = torch.zeros((B, Skv, Hkv, hd), dtype=dt), torch.zeros((B, Skv, Hkv, hd), dtype=dt)
    FK._launch_fwd(q, k, v, False, 0, 0.0, want_lse=False)
    FK._launch_fwd(q, k[:, :S].contiguous(), v[:, :S].contiguous(), True, 0, 0.0,
                   want_lse=True)
    names = [c[0] for c in rec.calls]
    assert names == ["flash_attention_fwd" + ("_tc_launch" if tc else "_launch")] * 2
    for (name, args), want_skv in zip(rec.calls, (Skv, S)):
        assert len(args) == len(_build.SIGNATURES[name])
        head = list(args[5:11] if tc else args[6:12])
        assert head == [B, S, H, Hkv, hd, want_skv]
        assert args[-3] == pytest.approx(1.0 / math.sqrt(hd)) and args[-2] == 0
    assert (FK.launches, FK.cross_launches, FK.tc_launches) == (2, 1, 2 * int(tc))
    q.requires_grad_(True)
    FK.FlashAttentionFn.apply(q, k, v, False, 0, 0.0).backward(torch.zeros_like(q))
    tc_bwd = dt == torch.bfloat16 and hd in (64, 128)
    name, args = rec.calls[-1]
    assert name == "flash_attention_bwd" + ("_tc_launch" if tc_bwd else "_launch")
    assert len(args) == len(_build.SIGNATURES[name])
    assert list(args[9:15] if tc_bwd else args[11:17]) == [B, S, H, Hkv, hd, Skv]
    assert args[-6:-3] == (0, 0, 0.0) and args[-3] == pytest.approx(1.0 / math.sqrt(hd))
    assert (FK.launches, FK.cross_launches, FK.bwd_launches, FK.cross_bwd_launches,
            FK.tc_bwd_launches) == (3, 2, 1, 1, int(tc_bwd))
    with pytest.raises(ValueError, match="keys of length"):  # before any launch
        FK.flash_attention(q.detach(), k, v, causal=True)
    with pytest.raises(ValueError, match="keys of length"):
        FK.FlashAttentionFn.apply(q, k, v, True, 0, 0.0)
    assert len(rec.calls) == 4

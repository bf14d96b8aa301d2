"""RecurrentGemma-9B and xLSTM-1.3B blocks against the reference on the CPU.

The port's ``models/ssm.py`` (mLSTM, sLSTM, the causal conv) and
``models/rglru.py`` (Griffin's RG-LRU) are held against ``repro/models``
on the same numpy inputs: the config copies field by field, each function
of the blocks, the serving storage of every new leaf, and at the reduced
configs the forward, the loss and every gradient leaf. Tolerances are
relative to the reference's largest value, fp32 on both sides: 1e-5 for a
single function, 1e-4 for a whole model (the bound of the reference's own
``tests/test_serving.py::test_dense_decode_parity_fallback_archs``); and
the simulator and the Trainer's launcher accept both families. The dense
serve path built on these blocks is tested in
tests/test_torch_dense_serve.py, their training in
tests/test_torch_recurrent_train.py and the files it names.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models import rglru as PRG  # noqa: E402
from repro_torch.models import ssm as PSSM  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")
FN_TOL = 1e-5
MODEL_TOL = 1e-4


def _jcfg(arch, **kw):
    """The reduced config in fp32."""
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32", **kw)


def _port_cfg(jcfg):
    return pt_config.ModelConfig(**dataclasses.asdict(jcfg))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _torch_tree(tree):
    return jax.tree.map(_t, tree)


# ===========================================================================
# the config copies
# ===========================================================================


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_reference(arch, get):
    jc, pc = getattr(jax_configs, get)(arch), getattr(pt_configs, get)(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.resolved_head_dim == jc.resolved_head_dim
    assert pc.resolved_lru_width == jc.resolved_lru_width
    assert arch in jax_configs.list_architectures() and arch in pt_configs.list_architectures()


def test_display_name_and_alias():
    """xLSTM's display name and alias resolve as in the reference."""
    for name in ("xlstm-1.3b", "xlstm-1-3b", "xlstm_1_3b", "XLSTM-1.3B"):
        assert pt_configs.get_config(name) == pt_configs.get_config("xlstm-1.3b")
        assert dataclasses.asdict(pt_configs.get_config(name)) == dataclasses.asdict(
            jax_configs.get_config(name))
    assert pt_configs.get_config("recurrentgemma_9b").name == "recurrentgemma-9b"


# ===========================================================================
# building blocks
# ===========================================================================


@pytest.mark.parametrize("W", [1, 4])
def test_causal_conv1d_one_pass_and_streamed(W):
    """One pass over S = 9, and the same input streamed a token at a time
    from a zero state (the decode path), against the reference's."""
    rng = np.random.default_rng(W)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    kern = rng.standard_normal((W, 6)).astype(np.float32)
    ref, _ = JSSM._causal_conv1d(jnp.asarray(x), jnp.asarray(kern))
    got, none = PSSM._causal_conv1d(_t(x), _t(kern))
    assert none is None and _rel_err(got.numpy(), ref) <= FN_TOL
    st_j, st_p = jnp.zeros((2, W - 1, 6)), torch.zeros((2, W - 1, 6))
    for t in range(9):
        yj, st_j = JSSM._causal_conv1d(jnp.asarray(x[:, t:t + 1]), jnp.asarray(kern), st_j)
        yp, st_p = PSSM._causal_conv1d(_t(x[:, t:t + 1]), _t(kern), st_p)
        assert _rel_err(yp.numpy(), yj) <= FN_TOL
        assert np.array_equal(st_p.numpy(), np.asarray(st_j))
        assert _rel_err(yp.numpy()[:, 0], ref[:, t]) <= FN_TOL


def _mlstm_inputs(seed, B=2, S=32, H=3, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, dh)).astype(np.float32) for _ in range(3))
    ig = (rng.standard_normal((B, S, H)) * 2).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) * 2 + 2).astype(np.float32)
    return q, k, v, ig, fg


def test_mlstm_parallel_and_chunkwise_match_reference():
    """The quadratic form, the chunkwise form at chunk 8 and 16, and the
    closed-form final state, each against the reference function."""
    args = _mlstm_inputs(0)
    ja, pa = [jnp.asarray(a) for a in args], [_t(a) for a in args]
    ref = np.asarray(JSSM.mlstm_parallel(*ja))
    assert np.isfinite(ref).all()
    assert _rel_err(PSSM.mlstm_parallel(*pa).numpy(), ref) <= FN_TOL
    for c in (8, 16):
        jc = np.asarray(JSSM.mlstm_chunkwise(*ja, chunk=c))
        got = PSSM.mlstm_chunkwise(*pa, chunk=c).numpy()
        assert np.isfinite(got).all() and _rel_err(got, jc) <= FN_TOL
        assert _rel_err(got, ref) <= FN_TOL
    for got, want in zip(PSSM.mlstm_final_state(*pa), JSSM.mlstm_final_state(*ja)):
        assert _rel_err(got.numpy(), want) <= FN_TOL


def test_mlstm_recurrent_steps_match_reference_and_final_state():
    """The decode step from the empty state (m = -inf) over the whole
    sequence, step by step against the reference's, ending at the closed
    form's state; every h within 1e-5 of the parallel form's."""
    args = _mlstm_inputs(1, S=12)
    B, S, H, dh = args[0].shape
    jst = (jnp.zeros((B, H, dh, dh)), jnp.zeros((B, H, dh)), jnp.full((B, H), -jnp.inf))
    pst = (torch.zeros((B, H, dh, dh)), torch.zeros((B, H, dh)), torch.full((B, H), -np.inf))
    par = np.asarray(JSSM.mlstm_parallel(*[jnp.asarray(a) for a in args]))
    for t in range(S):
        step = [a[:, t] for a in args]
        jst, jh = JSSM.mlstm_recurrent_step(jst, *[jnp.asarray(a) for a in step])
        pst, ph = PSSM.mlstm_recurrent_step(pst, *[_t(a) for a in step])
        assert np.isfinite(ph.numpy()).all()
        assert _rel_err(ph.numpy(), jh) <= FN_TOL
        assert _rel_err(ph.numpy(), par[:, t]) <= FN_TOL
    final = PSSM.mlstm_final_state(*[_t(a) for a in args])
    for got, want, closed in zip(pst, jst, final):
        assert _rel_err(got.numpy(), want) <= FN_TOL
        assert _rel_err(got.numpy(), closed.numpy()) <= FN_TOL


def test_slstm_scan_and_step_match_reference():
    """``apply_slstm`` over a sequence (the Python loop) with its final
    state, then two decode steps from that state, and ``slstm_cell``."""
    jcfg = _jcfg("xlstm-1.3b")
    cfg = _port_cfg(jcfg)
    jp = JSSM.init_slstm(jax.random.PRNGKey(0), jcfg)
    pp = _torch_tree(jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jo, js = JSSM.apply_slstm(jp, jnp.asarray(x), jcfg, return_state=True)
    po, ps = PSSM.apply_slstm(pp, _t(x), cfg, return_state=True)
    assert _rel_err(po.numpy(), jo) <= FN_TOL
    for got, want in zip(ps["cell"], js["cell"]):
        assert _rel_err(got.numpy(), want) <= FN_TOL
    for t in range(2):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, js = JSSM.apply_slstm(jp, jnp.asarray(xt), jcfg, state=js)
        po, ps = PSSM.apply_slstm(pp, _t(xt), cfg, state=ps)
        assert _rel_err(po.numpy(), jo) <= FN_TOL
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    xs = [rng.standard_normal((2, H, dh)).astype(np.float32) for _ in range(4)]
    jc, jh = JSSM.slstm_cell(jp, jcfg, js["cell"], *[jnp.asarray(a) for a in xs])
    pc, ph = PSSM.slstm_cell(pp, cfg, ps["cell"], *[_t(a) for a in xs])
    assert _rel_err(ph.numpy(), jh) <= FN_TOL
    for got, want in zip(pc, jc):
        assert _rel_err(got.numpy(), want) <= FN_TOL


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_rglru_linear_scan_matches_reference(S):
    """The log-depth scan against the reference's associative scan, with
    and without a carried-in state."""
    rng = np.random.default_rng(S)
    log_a = -np.abs(rng.standard_normal((2, S, 5))).astype(np.float32)
    x0 = rng.standard_normal((2, S, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32)
    for h in (None, h0):
        ref = JRG._linear_scan(jnp.asarray(log_a), jnp.asarray(x0),
                               None if h is None else jnp.asarray(h))
        got = PRG._linear_scan(_t(log_a), _t(x0), None if h is None else _t(h))
        assert _rel_err(got.numpy(), ref) <= FN_TOL
    # the recurrence itself, written out
    want, h = [], h0
    for t in range(S):
        h = np.exp(log_a[:, t]) * h + x0[:, t]
        want.append(h)
    assert _rel_err(PRG._linear_scan(_t(log_a), _t(x0), _t(h0)).numpy(),
                    np.stack(want, 1)) <= FN_TOL


def test_rglru_block_scan_and_step_match_reference():
    """``apply_rglru`` over a sequence with its final state, then decode
    steps from it, and the gates, against the reference's."""
    jcfg = _jcfg("recurrentgemma-9b")
    cfg = _port_cfg(jcfg)
    jp = JRG.init_rglru(jax.random.PRNGKey(1), jcfg)
    pp = _torch_tree(jp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jo, js = JRG.apply_rglru(jp, jnp.asarray(x), jcfg, return_state=True)
    po, ps = PRG.apply_rglru(pp, _t(x), cfg, return_state=True)
    assert _rel_err(po.numpy(), jo) <= FN_TOL
    for key in ("hidden", "conv"):
        assert _rel_err(ps[key].numpy(), js[key]) <= FN_TOL
    for t in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, js = JRG.apply_rglru(jp, jnp.asarray(xt), jcfg, state=js)
        po, ps = PRG.apply_rglru(pp, _t(xt), cfg, state=ps)
        assert _rel_err(po.numpy(), jo) <= FN_TOL
        assert _rel_err(ps["hidden"].numpy(), js["hidden"]) <= FN_TOL
    u = rng.standard_normal((2, 4, cfg.resolved_lru_width)).astype(np.float32)
    for got, want in zip(PRG._rglru_gates(pp, _t(u)), JRG._rglru_gates(jp, jnp.asarray(u))):
        assert _rel_err(got.numpy(), want) <= FN_TOL


# ===========================================================================
# serving storage
# ===========================================================================

# leaves the reference reads in fp32 (``.astype(jnp.float32)``) in each block
FP32_READS = {"rglru": {"w_a", "b_a", "w_i", "b_i", "lambda"},
              "mlstm": {"w_igate", "b_igate", "w_fgate", "b_fgate", "out_norm"},
              "slstm": {"w_i", "w_f", "w_z", "w_o", "b_i", "b_f", "b_z", "b_o",
                        "r_i", "r_f", "r_z", "r_o", "out_norm"}}
# leaves the reference casts to cfg.dtype at use (``L.cast``)
CAST_READS = {"rglru": {"w_x", "w_y", "conv", "w_down"},
              "mlstm": {"w_up", "conv", "wq", "wk", "wv", "w_down"},
              "slstm": {"w_down"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_storage_follows_the_references_reads(arch):
    """In bf16 serving storage every recurrent leaf the reference casts at
    use is bf16 and every one it reads in fp32 stays fp32 (the set is keyed
    by leaf name, and ``w_i`` is an fp32 read in both RG-LRU and sLSTM);
    training storage keeps all of them fp32."""
    jcfg = dataclasses.replace(jax_configs.get_reduced_config(arch))
    cfg = _port_cfg(jcfg)
    tree = _np_tree(JR.init_params(jax.random.PRNGKey(0), jcfg))
    served = params_from_jax(tree, cfg, device="cpu")
    trained = params_from_jax(tree, cfg, device="cpu", training=True)
    seen = set()
    for i, layer in enumerate(served["layers"]):
        kind = cfg.block_kind(i)
        if kind not in FP32_READS:  # attention: its leaves are all cast at use
            continue
        names = set(layer["mix"].keys())
        assert names == FP32_READS[kind] | CAST_READS[kind], (kind, names)
        for name in names:
            want = torch.bfloat16 if name in CAST_READS[kind] else torch.float32
            assert layer["mix"][name].dtype == want, (kind, name)
            assert trained["layers"][i]["mix"][name].dtype == torch.float32
        seen.add(kind)
    assert seen == ({"rglru"} if arch.startswith("recurrent") else {"mlstm", "slstm"})


# ===========================================================================
# forward, loss and gradients at the reduced configs
# ===========================================================================

# RecurrentGemma with a prompt longer than its window of 64; xLSTM at an S
# that is a multiple of its chunk of 16 (the chunkwise form) and one that
# is not (the parallel form)
MODEL_CASES = [pytest.param("recurrentgemma-9b", 80, id="recurrentgemma-s80"),
               pytest.param("xlstm-1.3b", 32, id="xlstm-s32-chunkwise"),
               pytest.param("xlstm-1.3b", 20, id="xlstm-s20-parallel")]


@pytest.mark.parametrize("arch,S", MODEL_CASES)
def test_forward_loss_and_grads_match_reference(arch, S):
    """Logits, loss and every gradient leaf within 1e-4 of the reference's
    largest value, fp32, on the same numpy weights. One leaf is zero in
    exact arithmetic: sLSTM's input-gate bias ``b_i`` (h = o c / n, and a
    shift of the input gate's pre-activation that is the same at every
    step scales c and n alike), so both packages' values are rounding noise;
    there both must lie below 1e-6 of the model's largest gradient."""
    jcfg = _jcfg(arch)
    cfg = _port_cfg(jcfg)
    tree = _np_tree(JR.init_params(jax.random.PRNGKey(2), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    labels[0, :4] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    ref, _ = jax.jit(lambda p: JR.forward(p, jcfg, jb))(jparams)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: JR.loss_fn(p, jcfg, jb),
                                             has_aux=True))(jparams)
    params = params_from_jax(tree, cfg, device="cpu", training=True)
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        logits, _ = PR.forward(params, cfg, pb)
    assert logits.shape == (2, S, cfg.vocab_size)
    assert _rel_err(logits.numpy(), ref) <= MODEL_TOL
    loss, _ = PR.loss_fn(params, cfg, pb)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= MODEL_TOL * abs(float(jl))
    leaves = param_leaves(params)
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(leaves) == len(jleaves)
    top = max(float(np.abs(g).max()) for g in jleaves)
    for (name, t), g in zip(leaves, jleaves):
        assert t.grad is not None and t.grad.shape == g.shape, name
        assert np.isfinite(t.grad.numpy()).all(), name
        layer = int(name.split(".")[1]) if name.startswith("layers.") else -1
        if name.endswith("mix.b_i") and cfg.block_kind(layer) == "slstm":
            assert max(np.abs(g).max(), t.grad.abs().max()) <= 1e-6 * top, name
            continue
        assert _rel_err(t.grad.numpy(), g) <= MODEL_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_training_refuses_recurrent_families(arch):
    """Since the recurrent families train, the name keeps its cases: the
    simulator builds on the CPU with every recurrent leaf in training
    storage (fp32, requiring grad) under AdamW and takes two steps of
    finite loss, and the Trainer's launcher accepts the arch. Their
    training is held against the reference in
    ``test_torch_recurrent_train.py``, ``test_torch_recurrent_sim*.py`` and
    ``test_torch_recurrent_trainer.py``."""
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.launch import train as LT

    cfg = pt_configs.get_reduced_config(arch)
    run = SimulatedRun(cfg, pt_config.TrainConfig(total_steps=4, global_batch_size=2,
                                                  seq_len=8), num_groups=1, device="cpu")
    leaves = param_leaves(run.state.params)
    assert all(t.dtype == torch.float32 and t.requires_grad for _, t in leaves)
    assert len(run.state.opt.mu) == len(leaves)
    assert all(np.isfinite(run.run(2)["train_loss"]))
    args = LT.build_parser().parse_args(["--reduced", "--arch", arch])
    mc, _, _ = LT.configs_from_args(args)
    assert mc.name == cfg.name
    assert PL.stored_dtype("w_i", cfg) == torch.float32

"""The port's sync controllers against the reference's, on the CPU.

- ``sync/overlap_model.py`` (the step-time model behind ``--chip``) equals
  ``benchmarks/overlap.py`` on every chip of the table over a grid of sizes
  (exact: the same float operations);
- the delay, measured, remeasure, warmup-scale and adaptive-ladder cases of
  ``tests/test_event_engine.py``, replayed with injected timings, and the
  port's controllers fed the same timings as the reference's give the same
  decisions (exact: host arithmetic);
- ``switch_strategy`` and the scripted controller in ``SimulatedRun``
  against the reference simulator across a switch, 12 steps at the
  reduced GPT-2 shape: loss within 1e-5, parameters, momentum and residuals
  within the tolerance of ``tests/test_torch_compress.py`` (5e-5).
"""

import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
from benchmarks import overlap as JO  # noqa: E402
from repro import sync as JS  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402
from repro_torch import sync as PS  # noqa: E402
from repro_torch.sync import overlap_model as PO  # noqa: E402

BLOCK = 64


def _tc(**kw):
    base = dict(optimizer="pier", total_steps=40, warmup_frac=0.25, sync_interval=5,
                global_batch_size=4, seq_len=16)
    base.update(kw)
    return pt_config.TrainConfig(**base)


def _jtc(**kw):
    base = dict(optimizer="pier", total_steps=40, warmup_frac=0.25, sync_interval=5,
                global_batch_size=4, seq_len=16)
    base.update(kw)
    return jax_config.TrainConfig(**base)


# ===========================================================================
# the step-time model
# ===========================================================================


def test_chip_table_is_the_reference_one():
    from benchmarks.hardware import CHIPS

    assert set(PO.CHIPS) == set(CHIPS)
    for name, chip in CHIPS.items():
        assert PO.CHIPS[name].__dict__ == chip.__dict__


@pytest.mark.parametrize("chip", ["tpu-v5e", "a100-perlmutter", "gh200-vista"])
def test_resolve_sync_delay_matches_reference(chip):
    """Every size of the grid, flat and hierarchical, fp32 and compressed:
    the same d* and the same period times (exact)."""
    for n_params in (1.25e8, 3.45e8, 1.5e9, 7e9):
        for n_dev, group in ((8, 4), (16, 4), (64, 8), (4, 1)):
            for bits, hier, pods in ((32, False, 1), (8, False, 1), (4, False, 1),
                                     (8, True, 2)):
                kw = dict(n_params=n_params, n_devices=n_dev, group_size=group,
                          sync_interval=50, chip=chip, bits=bits, block=256,
                          hierarchical=hier, pods=pods)
                assert PO.resolve_sync_delay(**kw) == JO.resolve_sync_delay(**kw), kw
                pt = dict(sync_interval=50, sync_delay=2, group_size=group, bits=bits,
                          hierarchical=hier, pods=pods)
                assert (PO.period_times(n_params, n_dev, PO.CHIPS[chip], **pt)
                        == JO.period_times(n_params, n_dev, JO.CHIPS[chip], **pt))


def test_unknown_chip_falls_back_to_eager():
    """An H100 is not in the reference's table: warn and resolve to eager,
    as the reference does; no chip hint gives no estimate silently."""
    with pytest.warns(UserWarning, match="unknown chip"):
        assert PO.resolve_sync_delay(n_params=1e9, n_devices=2, group_size=1,
                                     sync_interval=10, chip="h100") is None
    assert PO.resolve_sync_delay(n_params=1e9, n_devices=2, group_size=1,
                                 sync_interval=10, chip=None) is None


@pytest.mark.parametrize("chip", ["", "tpu-v5e", "a100-perlmutter", "h100"])
def test_model_delay_controller_matches_reference(chip):
    """The analytic controller on the reduced GPT-2 config, given the
    reference's parameter count: the same clamped d* (the port counts its
    own parameters when none is given)."""
    from repro.sync.delay import ModelDelayController as JM

    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
              vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
              positional="learned", max_position_embeddings=64, tie_embeddings=True)
    jmc, pmc = jax_config.ModelConfig(**kw), pt_config.ModelConfig(**kw)
    jpc = jax_config.ParallelConfig(data_axis_size=8, model_axis_size=1, data_outer=2,
                                    fsdp=False, shard_experts=False)
    ppc = pt_config.ParallelConfig(data_axis_size=8, data_outer=2)
    for comm in ({}, {"compression": "int8-wire"}):
        jtc = _jtc(outer_comm=jax_config.OuterCommConfig(**comm))
        ptc = _tc(outer_comm=pt_config.OuterCommConfig(**comm))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = JM(jtc, jmc, jpc, chip=chip).initial_delay()
            got = PS.ModelDelayController(ptc, pmc, ppc, chip=chip,
                                          n_params=jmc.param_count()).initial_delay()
            counted = PS.ModelDelayController(ptc, pmc, ppc, chip=chip).initial_delay()
        assert got == want == counted


# ===========================================================================
# delay controllers
# ===========================================================================


def test_fixed_delay_clamps_against_sync_interval():
    with pytest.warns(UserWarning, match="clamping"):
        ctrl = PS.FixedDelayController(7, sync_interval=5)
    assert ctrl.initial_delay() == 4
    with pytest.warns(UserWarning, match="clamping"):
        ctrl = PS.FixedDelayController(-1, sync_interval=5)
    assert ctrl.initial_delay() == 0
    assert PS.FixedDelayController(3, sync_interval=5).initial_delay() == 3
    with pytest.raises(ValueError):
        PS.FixedDelayController(-1)


def test_remeasure_every_reopens_measurement():
    ctrl = PS.MeasuredDelayController(_tc(sync_interval=10), min_windows=2, max_windows=2,
                                      skip_windows=0, remeasure_every=3)
    for _ in range(2):
        ctrl.observe_step(t_inner=0.01)
        ctrl.observe_window(t_comm=0.02)
        ctrl.tick_window()
    assert not ctrl.wants_measurement
    assert ctrl.current_delay() == 2
    for _ in range(3):  # three unmeasured windows -> a fresh burst
        assert not ctrl.wants_measurement
        ctrl.tick_window()
    assert ctrl.wants_measurement
    for _ in range(2):
        ctrl.observe_window(t_comm=0.08)
        ctrl.tick_window()
    assert not ctrl.wants_measurement
    assert ctrl.current_delay() > 2


def test_remeasure_zero_keeps_measure_once_behavior():
    ctrl = PS.MeasuredDelayController(_tc(), min_windows=2, max_windows=3, skip_windows=0)
    for _ in range(3):
        ctrl.observe_window(t_comm=0.1, t_inner=0.1)
        ctrl.tick_window()
    for _ in range(50):
        ctrl.tick_window()
    assert not ctrl.wants_measurement


def test_measured_skips_first_windows_and_scales_warmup():
    """The first window (first launches) is observed but not folded in;
    ``warmup=True`` samples are scaled by ``warmup_scale``; before
    ``min_windows`` the fallback answers; a measured 0.0 is a sample."""
    fb = PS.FixedDelayController(3, sync_interval=5)
    ctrl = PS.MeasuredDelayController(_tc(), fallback=fb, min_windows=2, skip_windows=1,
                                      warmup_scale=0.25)
    ctrl.observe_window(t_comm=9.0, t_inner=1.0, warmup=True)
    assert ctrl.t_comm is None and ctrl.current_delay() == 3
    ctrl.observe_window(t_comm=0.08, t_inner=0.01, warmup=True)
    assert ctrl.t_comm == pytest.approx(0.02) and ctrl.current_delay() == 3
    ctrl.observe_window(t_comm=0.0, t_inner=0.01)
    assert ctrl.current_delay() == 1  # ceil(0.01 / 0.01)


# (name, ladder start, [(t_inner, t_comm, warmup) per window], min, max, skip, remeasure)
SCENARIOS = [
    ("fits", "q8", [(0.01, 0.03, False)] * 4, 2, 2, 1, 0),
    ("exposed_then_fits", "q8", [(0.01, 0.1, False)] * 3 + [(0.01, 0.02, False)] * 4,
     2, 2, 1, 0),
    ("flat_walks_two_rungs", "flat", [(0.01, 0.5, False)] * 6 + [(0.01, 0.03, False)] * 3,
     2, 2, 1, 0),
    ("exhausted", "q4", [(0.01, 1.0, False)] * 5, 2, 2, 1, 0),
    ("warmup_scaled", "wire8", [(0.01, 0.2, True)] * 3 + [(0.01, 0.05, False)] * 3,
     2, 3, 1, 0),
    ("remeasure_drifts", "q8", [(0.01, 0.02, False)] * 3 + [(0.01, 0.09, False)] * 9,
     2, 2, 1, 3),
]


def _ladder_start(key, S):
    return {"q8": S.Quantized(8, BLOCK), "q4": S.Quantized(4, BLOCK),
            "flat": S.FlatFP32(), "wire8": S.Int8Wire(8, BLOCK)}[key]


def _drive(S, tc, scenario):
    _, start, timings, mn, mx, skip, rem = scenario
    strat = _ladder_start(start, S)
    ctrl = S.AdaptiveSyncController(tc, ladder=S.default_ladder(strat), min_windows=mn,
                                    max_windows=mx, skip_windows=skip, remeasure_every=rem,
                                    warmup_scale=strat.wire_bytes_per_param(tc) / 4.0)
    seq = [(ctrl.initial_decision().delay, None)]
    for t_inner, t_comm, warm in timings:
        if ctrl.wants_measurement:
            ctrl.observe_step(t_inner)
            ctrl.observe_window(t_comm=t_comm, warmup=warm)
        ctrl.tick_window()
        dec = ctrl.current_decision()
        seq.append((dec.delay, None if dec.strategy is None else dec.strategy.name,
                    ctrl.rung, ctrl.wants_measurement))
    return seq


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_adaptive_ladder_replays_the_reference(scenario):
    """The same injected timings through the reference's and the port's
    adaptive controller: the same delay, rung and switch at every window."""
    got = _drive(PS, _tc(sync_interval=5), scenario)
    want = _drive(JS, _jtc(sync_interval=5), scenario)
    assert got == want
    if scenario[0] == "exposed_then_fits":
        assert got[3][1] == "quantized(int4,block=64)" and got[3][0] == 4
        assert got[-1][:2] == (2, None)


def test_default_ladder_shapes():
    assert [s.name for s in PS.default_ladder(PS.FlatFP32())] == [
        "flat-fp32", "quantized(int8,block=256)", "quantized(int4,block=256)"]
    assert PS.default_ladder(PS.Quantized(8, BLOCK)) == (PS.Quantized(8, BLOCK),
                                                          PS.Quantized(4, BLOCK))
    assert PS.default_ladder(PS.Quantized(4, BLOCK)) == (PS.Quantized(4, BLOCK),)
    lad = PS.default_ladder(PS.FlatFP32(), num_pods=4)
    assert lad[-1] == PS.Hierarchical(inner=PS.Quantized(4, 256))
    lad = PS.default_ladder(PS.Hierarchical(inner=PS.Quantized(8, BLOCK)), num_pods=4)
    assert lad == (PS.Hierarchical(inner=PS.Quantized(8, BLOCK)),
                   PS.Hierarchical(inner=PS.Quantized(4, BLOCK)))
    rs = PS.Int8Wire(8, BLOCK, reduce_scatter=True)
    assert PS.default_ladder(rs)[1] == PS.Int8Wire(4, BLOCK, reduce_scatter=True)
    for strat, jstrat in ((PS.FlatFP32(), JS.FlatFP32()),
                          (PS.Int8Wire(8, 256), JS.Int8Wire(8, 256)),
                          (PS.Chunked(inner=PS.Quantized(8, 256), num_chunks=2),
                           JS.Chunked(inner=JS.Quantized(8, 256), num_chunks=2))):
        for pods in (1, 2):
            assert ([s.name for s in PS.default_ladder(strat, num_pods=pods)]
                    == [s.name for s in JS.default_ladder(jstrat, num_pods=pods)])


def test_make_sync_controller_hook():
    tc, pc = _tc(), pt_config.ParallelConfig()
    mc = pt_config.ModelConfig()
    default = PS.FlatFP32().make_sync_controller(tc, mc, pc, chip="", n_params=10)
    assert isinstance(default, PS.DelayDecisionAdapter)
    assert isinstance(default.delay_controller, PS.MeasuredDelayController)
    assert default.initial_decision().strategy is None
    adaptive = PS.Quantized(8, BLOCK).make_sync_controller(tc, mc, pc, chip="", adaptive=True,
                                                          remeasure_every=7, n_params=10)
    assert isinstance(adaptive, PS.AdaptiveSyncController)
    assert adaptive.ladder == (PS.Quantized(8, BLOCK), PS.Quantized(4, BLOCK))
    assert adaptive.delay_controller.remeasure_every == 7
    wire = PS.Int8Wire(8, 256).make_sync_controller(tc, mc, pc, n_params=10)
    assert wire.delay_controller.warmup_scale == (1.0 + 4.0 / 256) / 4.0


def test_scripted_controller_emits_strategy_once_and_replays():
    q4 = PS.Quantized(4, BLOCK)
    ctrl = PS.ScriptedSyncController(2, {2: q4})
    assert ctrl.initial_decision() == PS.SyncDecision(2, None)
    ctrl.tick_window()
    assert ctrl.current_decision() == PS.SyncDecision(2, None)
    ctrl.tick_window()
    assert ctrl.current_decision() == PS.SyncDecision(2, q4)
    ctrl.tick_window()
    assert ctrl.current_decision() == PS.SyncDecision(2, None)

    def drive(mk, n=8):
        c = mk()
        seq = [c.initial_decision()]
        for _ in range(n):
            c.tick_window()
            seq.append(c.current_decision())
        return [(d.delay, None if d.strategy is None else d.strategy.name) for d in seq]

    def port():
        return PS.ScriptedSyncController(2, {1: PS.SyncDecision(1, None),
                                             3: PS.Quantized(4, BLOCK),
                                             5: PS.SyncDecision(0, PS.Quantized(8, BLOCK))})

    def ref():
        return JS.ScriptedSyncController(2, {1: JS.SyncDecision(1, None),
                                             3: JS.Quantized(4, BLOCK),
                                             5: JS.SyncDecision(0, JS.Quantized(8, BLOCK))})

    assert drive(port) == drive(port) == drive(ref)
    assert not port().wants_measurement


def test_clamped_delay_edges():
    for d, interval in ((4, 5), (0, 5), (9, 5), (-2, 5), (3, 1)):
        assert (PS.SyncDecision(d).clamped_delay(interval)
                == JS.SyncDecision(d).clamped_delay(interval)
                == max(0, min(d, interval - 1)))


# ===========================================================================
# switch_strategy and the scripted controller in SimulatedRun
# ===========================================================================

MC_KW = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32", norm="layernorm", activation="gelu",
             positional="learned", max_position_embeddings=64, tie_embeddings=True)
TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4)
LOSS_TOL, STATE_TOL = 1e-5, 5e-5  # as tests/test_torch_compress.py, which says why


def _pair(script_port, script_ref):
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (4, 17)).astype(np.int32) for _ in range(12)]
    jr = JaxRun(jax_config.ModelConfig(**MC_KW), jax_config.TrainConfig(**TC_KW),
                num_groups=2, seed=0, sync_controller=script_ref)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pmc = pt_config.ModelConfig(**MC_KW)
    pr = SimulatedRun(pmc, pt_config.TrainConfig(**TC_KW), num_groups=2, device="cpu",
                      params=params_from_jax(tree, pmc, device="cpu", training=True),
                      sync_controller=script_port)
    pr._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                  "labels": torch.from_numpy(batches[s][:, 1:])}
    return jr, pr


def _close(port_leaves, ref_tree, tol):
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tree)]
    assert len(port_leaves) == len(ref)
    for t, x in zip(port_leaves, ref):
        assert tuple(t.shape) == x.shape
        assert np.abs(t.detach().numpy() - x).max() <= tol


def test_scripted_switch_matches_reference_simulator():
    """12 steps, G = 2, outer syncs after steps 5, 7, 9, 11: flat fp32, then
    Quantized(8, 256) from window 2 with the delay going 0 -> 1, rs-ag at
    window 3 (the second residual appears) and the plain int8 wire at 4 (it
    goes). The residuals appear at the switch and match the reference's.
    (int8 throughout: at int4 a Δθ one ulp apart moves an element by an
    int4 step, absmax / 7, so the runs part by more than this tolerance.)"""
    port = PS.ScriptedSyncController(0, {
        2: PS.SyncDecision(1, PS.Quantized(8, 256)),
        3: PS.Int8Wire(8, 256, reduce_scatter=True), 4: PS.Int8Wire(8, 256)})
    ref = JS.ScriptedSyncController(0, {
        2: JS.SyncDecision(1, JS.Quantized(8, 256)),
        3: JS.Int8Wire(8, 256, reduce_scatter=True), 4: JS.Int8Wire(8, 256)})
    jr, pr = _pair(port, ref)
    jh, ph = jr.run(6), pr.run(6)  # through window 1 (step 5): flat
    assert pr.state.outer.residual is None and pr.strategy.name == "flat-fp32"
    jh2, ph2 = jr.run(2), pr.run(2)  # window 2 (step 7): switch, delay 1
    assert pr.strategy.name == jr.strategy.name == "quantized(int8,block=256)"
    assert pr.tc.sync_delay == jr.tc.sync_delay == 1
    assert pr.state.outer.residual is not None and pr.state.outer.residual2 is None
    jh3, ph3 = jr.run(4), pr.run(4)
    jr.flush()
    pr.flush()
    assert pr.strategy.name == jr.strategy.name == "int8-wire(block=256)"
    assert pr.state.outer.residual2 is None and jr.state.outer.residual2 is None
    losses = ph["train_loss"] + ph2["train_loss"] + ph3["train_loss"]
    jlosses = jh["train_loss"] + jh2["train_loss"] + jh3["train_loss"]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=LOSS_TOL)
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs)
    _close([t for _, t in param_leaves(pr.eval_params())], jr.eval_params(), STATE_TOL)
    _close(pr.state.outer.momentum, jr.state.outer.momentum, STATE_TOL)
    _close(pr.state.outer.residual, jr.state.outer.residual, STATE_TOL)


def test_switch_strategy_retargets_residuals_as_the_reference():
    """A direct ``switch_strategy``: zeros of (G, *leaf) where the new plan
    needs a residual the state lacks, dropped where it does not; the
    momentum, anchor and sync count carry over; switching to the same
    strategy changes nothing."""
    jr, pr = _pair(None, None)
    jr.run(6), pr.run(6)
    mom = [m.clone() for m in pr.state.outer.momentum]
    for strat, jstrat in ((PS.Int8Wire(8, 256, reduce_scatter=True),
                           JS.Int8Wire(8, 256, reduce_scatter=True)),
                          (PS.Quantized(8, 256), JS.Quantized(8, 256)),
                          (PS.FlatFP32(), JS.FlatFP32())):
        pr.switch_strategy(strat)
        jr.switch_strategy(jstrat)
        for field in ("residual", "residual2"):
            p, j = getattr(pr.state.outer, field), getattr(jr.state.outer, field)
            assert (p is None) == (j is None), field
            if p is not None:
                assert all(float(r.abs().max()) == 0.0 for r in p)
                assert [tuple(r.shape) for r in p] == [
                    x.shape for x in jax.tree_util.tree_leaves(j)]
        assert all(torch.equal(a, b) for a, b in zip(mom, pr.state.outer.momentum))
    before = pr.plan
    pr.switch_strategy(PS.FlatFP32())
    assert pr.plan is before
    assert math.isfinite(pr.run(2)["train_loss"][-1])

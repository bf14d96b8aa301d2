"""Training DeepSeek-V2-236B (MLA + MoE) through the port's ``SimulatedRun``
against the reference simulator, on the CPU (Kimi-K2 in
``test_torch_moe_sim_kimi.py``, through the same helper).

12 steps at G = 2, flat fp32 outer sync, delay 0, at the reduced configs
in fp32, from the reference's initial parameters and the same numpy
batches: lazy start (two warmup steps on the global batch, one accumulate),
the switch to groups, and outer syncs every second step. The MoE layer's
capacity comes from each group's own token count, as under the
reference's ``vmap`` over the groups, and each step's loss is the total
(cross-entropy plus ``router_aux_loss_coef * moe_aux + 1e-4 * moe_z``).
The bounds are those of ``test_torch_qwen3.py``'s 12-step run: every loss
within 1e-5; each final leaf's difference within 1e-4 of how far the leaf
moved (L2 norms) and every element within 1.5e-4.

AdamW's eps is 1e-6 in the runs held to all of those bounds, not the
default 1e-8. At 1e-8 an element whose gradient falls within a few eps
of zero takes a normalized step g / (|g| + eps) that moves by a sizeable
part of its size under a rounding difference in g, and an untied
embedding row keeps stepping on those stale moments for every step its
token is absent. That breaks the bounds above whatever the model:
``test_torch_untied_eps.py`` shows it on reduced Qwen3 with its table
untied, which meets them at 1e-6 and at 1e-8 with the table tied. At
1e-8 (``test_torch_moe_sim_eps.py`` and the Kimi-K2 file) every leaf but
``embed.tokens`` is still held to the bounds; ``embed.tokens`` and the
losses are printed there, not held (measured: DeepSeek-V2 1.15e-3
elementwise and 5.7e-4 of the movement in the table, 1.05e-5 in the
loss at step 8; Kimi-K2 2.6e-4, 1.4e-4 and 9.5e-7).

Before each step both sides route that step's tokens with their current
parameters (a forward over each group's rows; in warmup the one replica's
over the same halves of the global batch, since a token's route depends
on its own sequence alone); the share of top-k assignments they make
alike (``routing_agree``) is printed a step and carried in the failure
messages, so a router near-tie that flips shows as such.

The reference's ``init_params`` runs as one jitted program while the
reference simulator is made (it gives the eager calls' bits; its per-op
compiles took about 4 s of this file). The port runs on one CPU thread
(``one_torch_thread``): these reduced models' operations are too small to
share, and beside other test processes 8 threads each made them many
times slower.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jax_config  # noqa: E402
import repro.configs as jax_configs  # noqa: E402
from repro.core.simulate import SimulatedRun as JaxRun  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import registry as JR  # noqa: E402
import repro_torch.config as pt_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.simulate import SimulatedRun  # noqa: E402
from repro_torch.models import moe as PMOE  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402
from repro_torch.models.transformer import param_leaves  # noqa: E402

TC_KW = dict(total_steps=40, global_batch_size=4, seq_len=16, sync_interval=2,
             warmup_frac=0.1, inner_lr=1e-3, inner_min_lr=1e-4, adam_eps=1e-6)
STEPS = 12


def _jcfg(arch):
    return dataclasses.replace(jax_configs.get_reduced_config(arch), dtype="float32",
                               param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's tests, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jitted_reference_init():
    """``repro.models.registry.init_params`` jitted while the block runs."""
    orig = JR.init_params
    JR.init_params = jax.jit(orig, static_argnums=1)
    try:
        yield
    finally:
        JR.init_params = orig


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _reference_routes(jcfg):
    """A jitted (params, tokens) -> [top-k ids per MoE layer] of the
    reference's forward: ``apply_moe`` wrapped while the function is
    traced, recomputing its router's top-k from the same input."""
    def routes(params, tokens):
        sink = []
        orig = JMOE.apply_moe

        def recording(p, x, cfg):
            logits = jnp.einsum("td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                                p["router"].astype(jnp.float32))
            sink.append(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                      cfg.num_experts_per_tok)[1])
            return orig(p, x, cfg)

        JMOE.apply_moe = recording
        try:
            JR.forward(params, jcfg, {"tokens": tokens})
        finally:
            JMOE.apply_moe = orig
        return sink

    return jax.jit(routes)


def _port_routes(params, cfg, tokens):
    sink = []
    orig = PMOE.route

    def recording(logits, k):
        out = orig(logits, k)
        sink.append(out[2])
        return out

    PMOE.route = recording
    try:
        with torch.no_grad():
            PR.forward(params, cfg, {"tokens": tokens})
    finally:
        PMOE.route = orig
    return sink


def _agree(port, ref) -> float:
    """The share of the port's top-k assignments the reference made too
    (per token, as sets)."""
    same = total = 0
    for a, b in zip(port, ref, strict=True):
        a, b = a.numpy(), np.asarray(b)
        same += int((a[:, :, None] == b[:, None, :]).any(-1).sum())
        total += a.size
    return same / total


def run_vs_reference(arch, *, adam_eps=1e-6, seed=7, untie=False, sync_delay=0):
    """12 steps of ``arch``'s reduced config through both simulators from
    the same parameters and batches (AdamW ``adam_eps``, batches from
    ``seed``, the embedding table untied where ``untie``, the outer sync
    ``sync_delay`` steps late). Returns the
    port's and the reference's losses, ``routing_agree`` per step (MoE
    models) and, per final leaf, its largest element difference and the
    L2 norm of its difference over that of the reference's movement."""
    jcfg = _jcfg(arch)
    if untie:
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
    cfg = pt_config.ModelConfig(**dataclasses.asdict(jcfg))
    kw = {**TC_KW, "adam_eps": adam_eps, "sync_delay": sync_delay}
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
               for _ in range(STEPS)]
    with jitted_reference_init():
        jr = JaxRun(jcfg, jax_config.TrainConfig(**kw), num_groups=2, seed=0)
    jr._global_batch = lambda s: {"tokens": jnp.asarray(batches[s][:, :-1]),
                                  "labels": jnp.asarray(batches[s][:, 1:])}
    tree = jax.tree.map(np.asarray, jr.state.params)
    pr = SimulatedRun(cfg, pt_config.TrainConfig(**kw), num_groups=2, device="cpu",
                      params=params_from_jax(tree, cfg, device="cpu", training=True))
    pr._global_batch = lambda s: {"tokens": torch.from_numpy(batches[s][:, :-1]),
                                  "labels": torch.from_numpy(batches[s][:, 1:])}
    ref_routes = _reference_routes(jcfg) if cfg.is_moe else None
    jloss, ploss, agree = [], [], []
    for s in range(STEPS):
        if ref_routes is not None:
            toks = batches[s][:, :-1]
            per = toks.shape[0] // 2
            if pr.state.group_params is None:  # warmup: one replica
                pairs = [(pr.state.params, jr.state.params, toks[g * per:(g + 1) * per])
                         for g in range(2)]
            else:
                pairs = [(pr.state.group_params[g],
                          jax.tree.map(lambda x, g=g: x[g], jr.state.group_params),
                          toks[g * per:(g + 1) * per]) for g in range(2)]
            port = [r for p, _, t in pairs for r in _port_routes(p, cfg, torch.from_numpy(t))]
            ref = [r for _, j, t in pairs for r in ref_routes(j, jnp.asarray(t))]
            agree.append(_agree(port, ref))
        jloss += jr.run(1)["train_loss"]
        ploss += pr.run(1)["train_loss"]
    jr.flush()
    pr.flush()
    assert pr.state.outer.num_syncs == int(jr.state.outer.num_syncs) == 6
    assert pr.state.group_params is not None  # the groups ran
    gaps = {}
    for (name, t), x, x0 in zip(param_leaves(pr.eval_params()), _leaves_np(jr.eval_params()),
                                _leaves_np(tree)):
        d = t.detach().numpy() - x
        gaps[name] = (float(np.abs(d).max()),
                      float(np.linalg.norm(d) / np.linalg.norm(x - x0)))
    return ploss, jloss, agree, gaps


def assert_within_bounds(ploss, jloss, gaps, why):
    """``test_torch_qwen3.py``'s 12-step bounds."""
    np.testing.assert_allclose(ploss, jloss, rtol=0, atol=1e-5, err_msg=why)
    for name, (elem, ratio) in gaps.items():
        assert ratio <= 1e-4, (name, ratio, why)
        assert elem <= 1.5e-4, (name, elem, why)


def simulated_run_vs_reference(arch):
    ploss, jloss, agree, gaps = run_vs_reference(arch)
    print(f"{arch}: routing_agree per step {agree}")
    assert_within_bounds(ploss, jloss, gaps, f"routing_agree per step {agree}")


def simulated_run_at_default_eps(arch):
    """AdamW's default eps: every leaf but the untied table held to the
    bounds; the table's gaps and the losses' printed."""
    ploss, jloss, agree, gaps = run_vs_reference(arch, adam_eps=1e-8)
    loss_gap = max(abs(a - b) for a, b in zip(ploss, jloss))
    print(f"{arch} at eps 1e-8: routing_agree per step {agree}; largest loss gap "
          f"{loss_gap}; embed.tokens (max |d|, |d| / movement) {gaps['embed.tokens']}")
    assert all(np.isfinite(ploss))
    del gaps["embed.tokens"]
    assert_within_bounds([], [], gaps, f"routing_agree per step {agree}")


def test_deepseek_simulated_run_matches_reference():
    simulated_run_vs_reference("deepseek-v2-236b")

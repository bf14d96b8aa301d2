"""Why the MoE families' 12-step comparisons hold their untied embedding
table only at AdamW eps 1e-6 (``test_torch_moe_sim.py``): the cause is the
untied table under the default eps, not MoE or MLA. Reduced Qwen3, a dense
model that meets the 12-step bounds at the default eps with its table
tied (``test_torch_qwen3.py``, on the same batches), is run with the table
untied: at eps 1e-8 it breaks the bounds, ``embed.tokens`` the leaf
furthest off (measured 9.3e-4 elementwise and 5.2e-4 of its movement,
against 1.5e-4 and 1e-4); at 1e-6 it meets them."""

import pytest

pytest.importorskip("torch")

from test_torch_moe_sim import (assert_within_bounds,  # noqa: E402
                                one_torch_thread,  # noqa: F401
                                run_vs_reference)


@pytest.mark.parametrize("adam_eps", [1e-8, 1e-6])
def test_untied_qwen3_simulated_run_vs_reference(adam_eps):
    # the batches of test_torch_qwen3.py's 12-step run
    ploss, jloss, _, gaps = run_vs_reference("qwen3-1.7b", adam_eps=adam_eps, seed=6,
                                             untie=True)
    print(f"untied qwen3 at eps {adam_eps}: {gaps}")
    assert "embed.lm_head" in gaps  # the table is untied
    if adam_eps == 1e-6:
        assert_within_bounds(ploss, jloss, gaps, "untied, eps 1e-6")
        return
    worst = max(gaps, key=lambda n: gaps[n][1])
    elem, ratio = gaps["embed.tokens"]
    assert worst == "embed.tokens", gaps
    assert ratio > 1e-4 and elem > 1.5e-4, gaps

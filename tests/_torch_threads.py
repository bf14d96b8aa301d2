"""One torch thread for a port test module.

A module takes it with ``from _torch_threads import one_torch_thread  #
noqa: E402,F401``: the module-scoped autouse fixture sets torch's CPU
thread count to 1 for the module's tests and restores it after. Under
``pytest -n 6`` six workers share the machine's cores, and a reduced
model's test on torch's default count (one thread a core) ran many times
slower than on one thread (``test_torch_moe_sim_kimi.py``: 229 s against
36.6 s). The count changes no assertion of these modules: none holds a
result to the bit across thread counts.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module's tests, the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""Train-to-serve hot handoff (counterpart of ``repro/serve/handoff.py``).

The trainer checkpoints through :class:`~repro_torch.checkpoint.
CheckpointManager`, whose manifest-last write order makes "complete" well
defined: a checkpoint is live when its ``manifest.json`` exists and every
archive it names passes the CRC sweep. ``latest_step()`` applies that
filter, so the poller never reads a checkpoint that is still being
written.

:class:`CheckpointPoller` watches the directory and, when a newer complete
step appears, loads the served parameters only (no optimizer moments, no
outer state) and hands them to the engine through ``engine.set_params``,
which installs them at the next step boundary. In-flight sequences keep
their KV blocks, cached by the old parameters; sequences admitted after
the swap run on the new ones alone.

Both layouts the reference reads are read here:

- the Trainer's (``launch/train.py``, the port's or the reference's):
  ``state.npz`` holding the (G,)-stacked ``TrainState``; the poller reads
  group ``group``'s row of every parameter leaf, and only that row;
- a plain ``params.npz`` holding an unstacked parameter tree (the
  simulator's and the tests' convention).

The parameters are built in the template's storage (the served module's
dtypes: bf16 matmul weights for serving) on its device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.transformer import param_leaves, with_leaves


class CheckpointPoller:
    """Poll a checkpoint directory for new complete steps.

    ``template`` is the served parameter module (``engine.params``): its
    leaf names, shapes, dtypes and device are what a checkpoint must give;
    one whose leaves are missing or of other shapes is refused with an
    error, not served.
    """

    def __init__(self, manager: Union[str, CheckpointManager], template, *, group: int = 0):
        self.mgr = CheckpointManager(manager) if isinstance(manager, str) else manager
        self.template = template
        self.group = group
        self.seen_step: Optional[int] = None
        self.swapped_steps: List[int] = []

    def poll(self) -> Optional[Tuple[int, Any]]:
        """(step, params) when a newer complete checkpoint exists, else None."""
        step = self.mgr.latest_step()
        if step is None or (self.seen_step is not None and step <= self.seen_step):
            return None
        params = self._load(step)
        self.seen_step = step
        return step, params

    def on_step(self, engine) -> None:
        """``engine.run(on_step=poller.on_step)``: swap at step boundaries."""
        got = self.poll()
        if got is not None:
            step, params = got
            engine.set_params(params)
            self.swapped_steps.append(step)

    # ------------------------------------------------------------------ load

    def _load(self, step: int):
        trees = self.mgr.manifest(step).get("trees", {})
        if "params" in trees:
            name, prefix, row = "params", "", None
        elif "state" in trees:
            name, prefix, row = "state", "params/", self.group
        else:
            raise ValueError(f"checkpoint step_{step:08d} carries neither a 'params' nor a "
                             f"'state' tree (found {sorted(trees)}); nothing to serve")
        keys = set(trees[name])
        out = {}
        with self.mgr.reader(step, name) as rd:
            for n, leaf in param_leaves(self.template):
                key = prefix + n.replace(".", "/")
                if key not in keys:
                    raise ValueError(f"checkpoint step_{step:08d}: param {key!r} missing "
                                     f"from {name}.npz")
                # raises on a row out of range or a shape other than the template's
                out[n] = rd.tensor(key, leaf, row, where=f"step_{step:08d}/{name}/{key}")
        return with_leaves(self.template, out)

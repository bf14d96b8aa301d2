"""Checkpoints: one ``.npz`` per tree plus a JSON manifest
(counterpart of ``repro/checkpoint/manager.py``, the same format).

A checkpoint of step ``s`` is the directory ``step_{s:08d}`` holding one
``{name}.npz`` per saved tree, its arrays under their pytree-path keys
(``params/layers/0/mix/wq``, ``opt/mu/embed/tokens``, ``num_syncs``), and
``manifest.json`` (step, time, metadata, each tree's sorted keys). The
port names leaves as ``convert.params_from_jax`` does, so a tree saved by
either package restores in the other.

The reference's crash rules hold: every archive is written under a
``.tmp`` name and renamed into place, the manifest is written last (its
presence marks the checkpoint complete), and the step directory is built
as ``step_*.tmp`` and renamed. :meth:`CheckpointManager.all_steps` and
:meth:`~CheckpointManager.latest_step` skip an incomplete or corrupt step
with a warning; ``keep`` complete checkpoints survive garbage collection.

Trees are nested dicts, NamedTuples (their fields; ``None`` fields hold no
leaf, as in a pytree), lists, parameter modules (their
``transformer.param_leaves`` names), tensors, numpy arrays and Python
numbers. bf16 leaves have no numpy dtype: they are stored as the
reference stores them (the raw two-byte values under the dtype string
``<V2``) and restored into a bf16 template by their bytes. The template's
dtype is authoritative on restore, and every shape is checked.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import time
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_BF16_DESCR = "<V2"  # what numpy writes for the reference's bfloat16 arrays


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """Children of a tree node as (key, child), or None for a leaf."""
    if isinstance(tree, torch.nn.Module):
        from repro_torch.models.transformer import param_leaves

        return [(n.replace(".", _SEP), t) for n, t in param_leaves(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields if getattr(tree, f) is not None]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _items(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out += _flatten(child, prefix + _SEP + k if prefix else k)
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _contiguous(arr: np.ndarray) -> np.ndarray:
    return arr if arr.flags.c_contiguous else arr.copy(order="C")  # keeps 0-d arrays 0-d


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    if arr.dtype == np.dtype("V2"):
        # the reference's bf16 header: '<V2' (numpy alone would write '|V2')
        np.lib.format.write_array_header_1_0(
            buf, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        buf.write(_contiguous(arr).tobytes())
    else:
        np.lib.format.write_array(buf, _contiguous(arr), allow_pickle=False)
    return buf.getvalue()


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s layout (stored, one ``key.npy`` a member)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as z:
        for k, a in arrays.items():
            z.writestr(k + ".npy", _npy_bytes(a))


def _from_numpy(arr: np.ndarray, leaf, where: str):
    """``arr`` as the template ``leaf``'s type, dtype and device."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"checkpoint/{where}: shape {arr.shape} != expected {shape} "
                         f"(group layout mismatch?)")
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                t = torch.from_numpy(_contiguous(arr).view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)
        elif arr.dtype.kind == "V":
            raise ValueError(f"checkpoint/{where}: a {arr.dtype} array (bf16 bytes) cannot "
                             f"restore into a {leaf.dtype} template")
        else:
            t = torch.from_numpy(_contiguous(arr)).to(leaf.dtype)
        return t.to(leaf.device)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    return type(leaf)(arr.item())


def _rebuild(template, flat: Dict[str, Any], prefix: str = ""):
    """The template's structure with its leaves taken from ``flat``; a
    parameter module becomes a dict of its leaves in leaf order."""
    if isinstance(template, torch.nn.Module):
        return {k: flat[prefix + _SEP + k if prefix else k] for k, _ in _items(template)}
    kids = _items(template)
    if kids is None:
        return flat[prefix]
    built = {k: _rebuild(child, flat, prefix + _SEP + k if prefix else k) for k, child in kids}
    if isinstance(template, dict):
        return {k: built[str(k)] for k in template}
    if _is_namedtuple(template):
        return type(template)(**{f: built.get(f) for f in template._fields})
    return type(template)(built[str(i)] for i in range(len(template)))


class CheckpointManager:
    """Crash-safe checkpoints under ``directory`` (``keep`` newest survive)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._warned = set()  # steps already warned about, once each
        self._verified = set()  # steps that passed the completeness check
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, trees: Dict[str, Any], metadata: Optional[Dict] = None) -> str:
        """``trees``: name -> tree (e.g. ``{"state": ..., "outer": ...}``)."""
        path = self._path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):  # stale debris from a crashed save
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "metadata": metadata or {},
                    "trees": {}}
        for name, tree in trees.items():
            arrays = {}
            for key, leaf in _flatten(tree):
                if key in arrays:
                    raise ValueError(f"duplicate checkpoint key {key!r} in tree {name!r}")
                arrays[key] = _to_numpy(leaf)
            dest = os.path.join(tmp, f"{name}.npz")
            _write_npz(dest + ".tmp.npz", arrays)
            os.replace(dest + ".tmp.npz", dest)
            manifest["trees"][name] = sorted(arrays)
        mdest = os.path.join(tmp, "manifest.json")
        with open(mdest + ".tmp", "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(mdest + ".tmp", mdest)  # the completeness marker, last
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()
        return path

    def _gc(self):
        steps = self.all_steps()  # complete checkpoints only
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _step_error(self, step: int) -> Optional[str]:
        """Why ``step``'s checkpoint is unusable (``None``: complete)."""
        path = self._path(step)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            return f"manifest unreadable ({e})"
        for name, keys in manifest.get("trees", {}).items():
            p = os.path.join(path, f"{name}.npz")
            try:
                with zipfile.ZipFile(p) as z:
                    if z.testzip() is not None:
                        return f"{name}.npz fails CRC (truncated write?)"
                    have = {n[:-4] if n.endswith(".npy") else n for n in z.namelist()}
            except (OSError, zipfile.BadZipFile) as e:
                return f"{name}.npz unreadable ({e})"
            missing = [k for k in keys if k not in have]
            if missing:
                return f"{name}.npz missing arrays {missing[:3]}"
        return None

    def _usable(self, step: int) -> bool:
        if step in self._verified:  # complete checkpoints are immutable
            return True
        err = self._step_error(step)
        if err is None:
            self._verified.add(step)
            return True
        if step not in self._warned:
            self._warned.add(step)
            warnings.warn(f"skipping corrupt checkpoint step_{step:08d}: {err}", stacklevel=3)
        return False

    def all_steps(self) -> List[int]:
        """Sorted steps with complete checkpoints (the others are skipped
        with a warning, once a step)."""
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and self._usable(int(m.group(1))):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict]:
        """``templates``: name -> a tree like the saved one. Returns (trees,
        metadata): each tree in its template's structure, every leaf of its
        template's dtype on its template's device (a parameter module comes
        back as a dict of its leaves, in leaf order)."""
        if step not in self._verified:
            err = self._step_error(step)
            if err is not None:
                raise ValueError(f"checkpoint step_{step:08d} is incomplete/corrupt ({err}); "
                                 f"pick a step from all_steps()")
            self._verified.add(step)
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name, template in templates.items():
            flat = {}
            with np.load(os.path.join(path, f"{name}.npz")) as data:
                for key, leaf in _flatten(template):
                    flat[key] = _from_numpy(data[key], leaf, f"{name}/{key}")
            out[name] = _rebuild(template, flat)
        return out, manifest["metadata"]

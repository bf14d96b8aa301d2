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

Large trees stream. A :class:`Rows` leaf is a stack that is written a row
at a time as its iterator yields them (the Trainer's (G,)-stacked state,
each row received from its group's rank), and
:meth:`CheckpointManager.reader` reads one row of a stacked array without
the others: a stored member is a contiguous byte range after its ``.npy``
header, so a reader seeks to the row.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import struct
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


def _npy_header(shape, dtype: np.dtype) -> bytes:
    """The ``.npy`` header of a C-ordered array; bf16 bytes get the
    reference's ``'<V2'`` (numpy alone would write ``'|V2'``)."""
    buf = io.BytesIO()
    descr = _BF16_DESCR if dtype == np.dtype("V2") else np.lib.format.dtype_to_descr(dtype)
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype that a leaf of torch or numpy ``dtype`` is stored as."""
    if isinstance(dtype, torch.dtype):
        return _to_numpy(torch.empty(0, dtype=dtype)).dtype
    return np.dtype(dtype)


class Rows:
    """A leaf saved as the stack of ``n`` rows that ``rows`` yields in order,
    each a tensor or numpy array of ``shape`` and ``dtype`` (a torch or a
    numpy dtype): the archive member is written a row at a time, so one
    row is in memory, not the stack."""

    def __init__(self, n: int, shape, dtype, rows):
        self.n, self.shape, self.dtype, self.rows = n, tuple(shape), _np_dtype(dtype), rows


def _members(tree) -> List[Tuple[str, tuple, np.dtype, Any]]:
    """(key, shape, dtype, chunks) of every leaf; the chunks' bytes, in
    order, are the array's in C order. A tensor leaf is its own chunk, so
    it reaches the host only as its member is written."""
    out = []
    for key, leaf in _flatten(tree):
        if isinstance(leaf, Rows):
            out.append((key, (leaf.n, *leaf.shape), leaf.dtype, leaf.rows))
        elif isinstance(leaf, torch.Tensor):
            out.append((key, tuple(leaf.shape), _np_dtype(leaf.dtype), [leaf]))
        else:
            arr = np.asarray(leaf)
            out.append((key, arr.shape, arr.dtype, [arr]))
    return out


def _write_npz(path: str, members) -> List[str]:
    """``np.savez``'s layout (stored, one ``key.npy`` a member), each member
    streamed chunk by chunk. Returns the keys."""
    keys = set()
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as z:
        for key, shape, dtype, chunks in members:
            if key in keys:
                raise ValueError(f"duplicate checkpoint key {key!r}")
            keys.add(key)
            header = _npy_header(shape, dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_STORED
            info.file_size = len(header) + nbytes  # sizes the zip64 decision
            with z.open(info, "w") as f:
                f.write(header)
                written = 0
                for chunk in chunks:
                    chunk = _contiguous(_to_numpy(chunk))
                    f.write(chunk.reshape(-1).view(np.uint8))
                    written += chunk.nbytes
            if written != nbytes:
                raise ValueError(f"checkpoint/{key}: {written} bytes written for a "
                                 f"{shape} {dtype} array of {nbytes}")
    return sorted(keys)


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


class _NpzRows:
    """Reads arrays, or one row of a stacked array, out of a stored npz
    without loading the rest: a stored member is a contiguous byte range
    after its ``.npy`` header."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.f = open(self.path, "rb")
        self.z = zipfile.ZipFile(self.f)
        return self

    def __exit__(self, *exc):
        self.z.close()
        self.f.close()

    def read(self, key: str, row: Optional[int] = None) -> np.ndarray:
        """The array under ``key``, or its row ``row`` (``arr[row]``)."""
        try:
            info = self.z.getinfo(key + ".npy")
        except KeyError:
            raise KeyError(f"{key!r} is not in {self.path}") from None
        if info.compress_type != zipfile.ZIP_STORED:  # np.savez stores; so do both managers
            raise ValueError(f"{key!r} in {self.path} is compressed, not stored")
        f = self.f
        f.seek(info.header_offset)
        local = struct.unpack(zipfile.structFileHeader, f.read(zipfile.sizeFileHeader))
        f.seek(local[zipfile._FH_FILENAME_LENGTH] + local[zipfile._FH_EXTRA_FIELD_LENGTH], 1)
        version = np.lib.format.read_magic(f)
        if version not in _HEADER_READERS:
            raise ValueError(f"{key!r}: .npy format version {version}")
        shape, fortran, dtype = _HEADER_READERS[version](f)
        if fortran:
            raise ValueError(f"{key!r}: a Fortran-ordered array")
        if row is not None:
            if not shape or not 0 <= row < shape[0]:
                raise ValueError(f"{key!r}: row {row} of an array of shape {shape}")
            shape = shape[1:]
            f.seek(row * int(np.prod(shape, dtype=np.int64)) * dtype.itemsize, 1)
        buf = bytearray(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{key!r}: the archive ends early")
        return np.frombuffer(buf, dtype).reshape(shape)

    def tensor(self, key: str, like, row: Optional[int] = None, *, where: str = ""):
        """``read(key, row)`` as the template ``like``'s type, dtype and
        device (its shape is checked)."""
        return _from_numpy(self.read(key, row), like, where or key)


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
        """``trees``: name -> tree (e.g. ``{"state": ..., "outer": ...}``).
        A :class:`Rows` leaf is written a row at a time, as it is yielded."""
        path = self._path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):  # stale debris from a crashed save
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "metadata": metadata or {},
                    "trees": {}}
        for name, tree in trees.items():
            dest = os.path.join(tmp, f"{name}.npz")
            try:
                manifest["trees"][name] = _write_npz(dest + ".tmp.npz", _members(tree))
            except ValueError as e:
                raise ValueError(f"tree {name!r}: {e}") from None
            os.replace(dest + ".tmp.npz", dest)
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

    def _check(self, step: int) -> None:
        if step not in self._verified:
            err = self._step_error(step)
            if err is not None:
                raise ValueError(f"checkpoint step_{step:08d} is incomplete/corrupt ({err}); "
                                 f"pick a step from all_steps()")
            self._verified.add(step)

    def manifest(self, step: int) -> Dict:
        """``step``'s manifest: its ``metadata`` and each tree's keys."""
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)

    def reader(self, step: int, name: str, *, check: bool = True) -> "_NpzRows":
        """A reader of tree ``name`` of ``step`` (a context manager): whole
        arrays, or one row of a stacked array without the others. ``check``:
        make sure the step is complete first (its CRC sweep, once a step);
        ``False`` on a Trainer rank whose rank 0 has checked it."""
        if check:
            self._check(step)
        return _NpzRows(os.path.join(self._path(step), f"{name}.npz"))

    def restore(self, step: int, templates: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict]:
        """``templates``: name -> a tree like the saved one. Returns (trees,
        metadata): each tree in its template's structure, every leaf of its
        template's dtype on its template's device (a parameter module comes
        back as a dict of its leaves, in leaf order)."""
        out = {}
        for name, template in templates.items():
            with self.reader(step, name) as rd:
                flat = {key: rd.tensor(key, leaf, where=f"{name}/{key}")
                        for key, leaf in _flatten(template)}
            out[name] = _rebuild(template, flat)
        return out, self.manifest(step)["metadata"]

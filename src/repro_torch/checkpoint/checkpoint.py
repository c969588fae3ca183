"""Flat-npz tree checkpoints with crash-safe writes and step indexing — the
port of ``repro/checkpoint/checkpoint.py``, file for file.

Layout: ``<dir>/ckpt_<step>.npz``, one entry per leaf, keyed by the leaf's
``/``-joined tree path (dict keys, sequence indices, NamedTuple field names:
``tree.tree_flatten_with_path``, the paths JAX gives).  Restore takes a
template tree for the structure, dtypes and devices.

Crash safety (DESIGN §15): a learner can die mid-write, so a checkpoint
becomes visible only by an atomic rename of a fully written, fsynced
temporary file, and carries a content digest (sha256 over the sorted keys,
each array's dtype, shape and bytes, stored as the ``__digest__`` entry).
``restore_checkpoint`` verifies the digest and, asked for the latest step,
falls back to the newest undamaged checkpoint: a truncated or bit-flipped
file is skipped, never loaded.

A float32, int32 or bool file written by either package verifies and
restores in the other.  numpy has no bfloat16: a bf16 leaf is stored as its
raw bits, a uint16 array, and its key is listed in a ``__bfloat16__`` entry
(the keys joined by newlines, as uint8), which the digest covers like any
other entry.  Such a file verifies in the reference, but the reference
would restore those leaves as the integers their bits spell.
"""
from __future__ import annotations

import hashlib
import os
import re
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from ..tree import tree_flatten, tree_flatten_with_path, tree_unflatten

DIGEST_KEY = "__digest__"
BF16_KEY = "__bfloat16__"


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    out, bf16 = {}, []
    for path, leaf in tree_flatten_with_path(tree):
        key = _key(path)
        out[key] = _to_numpy(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16.append(key)
    if bf16:
        out[BF16_KEY] = np.frombuffer("\n".join(bf16).encode(), np.uint8)
    return out


def _digest(arrays: dict) -> str:
    """The reference's digest, byte for byte (it hashes ``tobytes()``;
    the contiguous array's buffer is the same bytes without the copy)."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        if key == DIGEST_KEY:
            continue
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` as ``<directory>/ckpt_<step>.npz`` and return the
    path.  The file appears only once fully written and fsynced; a failure
    on the way leaves no file and no temporary behind."""
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten(tree)
    arrays[DIGEST_KEY] = np.frombuffer(_digest(arrays).encode(), np.uint8)
    path = os.path.join(directory, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())       # durable before it becomes visible
        os.replace(tmp, path)          # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.fullmatch(r"ckpt_(\d+)\.npz", f)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return max(steps) if steps else None


def _load_verified(directory: str, step: int) -> Optional[dict]:
    """The arrays of ``ckpt_<step>.npz`` if it unzips and its digest
    matches, else None."""
    path = os.path.join(directory, f"ckpt_{step}.npz")
    try:
        with np.load(path) as data:
            if DIGEST_KEY not in data.files:
                return None             # a pre-digest file or a torn write
            want = bytes(data[DIGEST_KEY]).decode()
            arrays = {k: data[k] for k in data.files if k != DIGEST_KEY}
        return arrays if _digest(arrays) == want else None
    except Exception:
        return None


def verify_checkpoint(directory: str, step: int) -> bool:
    """True iff ``ckpt_<step>.npz`` exists, unzips and its content digest
    matches: the file survived whatever killed its writer."""
    return _load_verified(directory, step) is not None


def _restore_leaf(arr: np.ndarray, leaf, bf16: bool):
    if isinstance(leaf, torch.Tensor):
        if bf16:
            t = torch.as_tensor(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.as_tensor(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.astype(leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return arr


def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """Returns (tree, step): the checkpoint laid out as ``template`` (its
    structure; each tensor leaf's dtype and device).  Raises
    ``FileNotFoundError`` if nothing loadable is there.

    ``step=None`` scans from the newest step down and skips a corrupt or
    truncated file; an explicit ``step`` is strict: a corrupt file raises
    ``ValueError``.
    """
    if step is None:
        candidates = _steps(directory)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        for s in reversed(candidates):
            arrays = _load_verified(directory, s)
            if arrays is not None:
                step = s
                break
        else:
            raise FileNotFoundError(
                f"no uncorrupted checkpoint in {directory} "
                f"(tried steps {candidates})")
    else:
        arrays = _load_verified(directory, step)
        if arrays is None:
            raise ValueError(
                f"checkpoint ckpt_{step}.npz is corrupt or predates the "
                "digest format; refusing to load it explicitly")
    paths = tree_flatten_with_path(template)
    keys = [_key(p) for p, _ in paths]
    missing = set(keys) - set(arrays)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    bf16 = set()
    if BF16_KEY in arrays:
        bf16 = set(bytes(arrays[BF16_KEY]).decode().split("\n"))
    leaves = [_restore_leaf(arrays[k], leaf, k in bf16)
              for k, (_, leaf) in zip(keys, paths)]
    return tree_unflatten(tree_flatten(template)[1], leaves), step

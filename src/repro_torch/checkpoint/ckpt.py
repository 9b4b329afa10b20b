"""Crash-safe, dependency-free checkpoints of a tree of tensors (the
counterpart of :mod:`repro.checkpoint.ckpt`, byte-compatible with it).

Leaves are stored in one ``.npz`` per step, ``leaf_<i>`` in the tree's
leaf order; the manifest — version, step, the leaves' keys (the
``/``-joined paths of :func:`repro_torch.utils.tree_flatten_with_path`,
which are the JAX package's) and a SHA-256 of each leaf — is embedded in
the same ``.npz`` as its ``__manifest__`` entry, so arrays and manifest
commit in one ``os.replace``.  A checkpoint written by either package
restores in the other.

* **atomic commit** — the write goes to ``<name>.tmp-<pid>``, is fsynced
  and renamed into place;
* **completeness** — :func:`latest_step` counts only complete units (an
  intact zip with its manifest, or a legacy v1 npz with its sidecar json);
* **integrity and fallback** — :func:`restore_checkpoint` checks the
  container and every leaf's checksum; a damaged newest checkpoint is
  quarantined (renamed ``*.corrupt``, with a warning) and the newest valid
  one restores instead.  A pinned ``step`` raises instead;
* **hygiene** — stale ``*.tmp*`` files are removed on every save and
  restore in the directory, and ``keep_last`` bounds the committed ones.

Leaves on the way out: a tensor is copied to the host; a bf16 tensor is
written as the 2-byte ``|V2`` records that ``np.savez`` writes for the JAX
package's bfloat16, its checksum taken over the dtype name ``bfloat16``,
as the JAX package takes it; a host int (``TrainState.step``, a guard
state's ``k``) is a 0-d int32 leaf, as the JAX package's arrays are.  On
the way in, a ``|V2`` leaf whose template leaf is bf16 is read as bf16
before it is hashed (the JAX package hashes it under ``|V2`` and
quarantines its own bf16 checkpoints), and every leaf takes its template
leaf's dtype and device; an int template leaf comes back a host int.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import warnings
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_flatten_with_path, tree_unflatten

CKPT_VERSION = 2
_MANIFEST_KEY = "__manifest__"
_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
_TMP_RE = re.compile(r"\.tmp[^/]*$")
_BF16_RECORD = np.dtype("V2")   # np.savez's record for a 2-byte extension dtype
_BF16_NAME = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed container or checksum verification.

    Raised to the caller only for an explicitly pinned ``step``; the
    newest-valid walk catches it, quarantines the file and falls back to
    the checkpoint before it.
    """


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk and the dtype name its checksum
    is taken over."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD), _BF16_NAME
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        raise TypeError(f"a checkpoint holds tensors and host ints, not {type(leaf)}")
    return arr, str(arr.dtype)


def _leaf_sha256(arr: np.ndarray, dtype_name: str | None = None) -> str:
    h = hashlib.sha256()
    h.update((str(arr.dtype) if dtype_name is None else dtype_name).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _npz_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")


def _json_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.json")


def clean_stale_tmp(ckpt_dir: str) -> list[str]:
    """Remove orphaned ``*.tmp*`` files a crashed save left behind (one
    writer a directory); returns the removed paths."""
    if not os.path.isdir(ckpt_dir):
        return []
    removed = []
    for f in os.listdir(ckpt_dir):
        if _TMP_RE.search(f):
            path = os.path.join(ckpt_dir, f)
            try:
                os.remove(path)
                removed.append(path)
            except OSError:  # pragma: no cover — racing delete
                pass
    return removed


def _is_complete(ckpt_dir: str, fname: str, step: int) -> bool:
    """v2: the manifest inside an intact zip; v1 (legacy): the npz and its
    sidecar json both present."""
    path = os.path.join(ckpt_dir, fname)
    try:
        with zipfile.ZipFile(path) as zf:
            if f"{_MANIFEST_KEY}.npy" in zf.namelist():
                return True
    except (zipfile.BadZipFile, OSError):
        return False
    return os.path.exists(_json_path(ckpt_dir, step))


def _complete_steps(ckpt_dir: str) -> list[int]:
    """Steps with a complete checkpoint unit, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for f in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(f)
        if m and _is_complete(ckpt_dir, f, int(m.group(1))):
            steps.append(int(m.group(1)))
    return sorted(steps)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, keep_last: int | None = None) -> str:
    """Atomically write ``tree`` as the step-``step`` checkpoint; with
    ``keep_last`` prune all but the newest N committed checkpoints once
    the new one is durable.  Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    clean_stale_tmp(ckpt_dir)
    items = tree_flatten_with_path(tree)
    arrays, checksums = {}, []
    for i, (_, leaf) in enumerate(items):
        arr, name = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        checksums.append(_leaf_sha256(arr, name))
    manifest = {"version": CKPT_VERSION, "step": int(step), "keys": [k for k, _ in items],
                "checksums": checksums}
    arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    path = _npz_path(ckpt_dir, step)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if keep_last is not None and keep_last > 0:
        for old in _complete_steps(ckpt_dir)[:-keep_last]:
            for stale in (_npz_path(ckpt_dir, old), _json_path(ckpt_dir, old)):
                if os.path.exists(stale):
                    os.remove(stale)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete checkpoint unit, or None."""
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_unit(ckpt_dir: str, step: int, bf16_keys: frozenset = frozenset()):
    """Load and check one checkpoint unit → (manifest, npz data); a ``|V2``
    leaf under a key of ``bf16_keys`` is hashed as bfloat16.  Raises
    :class:`CheckpointCorruptError` on any container, manifest or checksum
    failure."""
    path = _npz_path(ckpt_dir, step)
    try:
        data = np.load(path, allow_pickle=False)
        names = set(data.files)
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable container: {e}") from e
    if _MANIFEST_KEY in names:
        try:
            manifest = json.loads(bytes(np.asarray(data[_MANIFEST_KEY])))
        except (ValueError, KeyError) as e:
            raise CheckpointCorruptError(f"{path}: bad manifest: {e}") from e
    else:
        # legacy v1: sidecar manifest, no checksums to verify
        try:
            with open(_json_path(ckpt_dir, step)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: missing/bad legacy sidecar manifest: {e}") from e
        manifest.setdefault("version", 1)
    keys = manifest.get("keys")
    if not isinstance(keys, list):
        raise CheckpointCorruptError(f"{path}: manifest has no key list")
    checksums = manifest.get("checksums")
    for i, key in enumerate(keys):
        name = f"leaf_{i}"
        if name not in names:
            raise CheckpointCorruptError(f"{path}: missing array {name} ({key})")
        try:
            arr = data[name]
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: truncated array {name} ({key}): {e}") from e
        as_bf16 = arr.dtype == _BF16_RECORD and key in bf16_keys
        if checksums is not None and \
                _leaf_sha256(arr, _BF16_NAME if as_bf16 else None) != checksums[i]:
            raise CheckpointCorruptError(
                f"{path}: checksum mismatch on {name} ({key}) — silent "
                "corruption (bit rot or a torn write)")
    return manifest, data


def _quarantine(ckpt_dir: str, step: int, reason: str) -> None:
    """Move a failed checkpoint unit aside (``*.corrupt``)."""
    warnings.warn(f"checkpoint step {step} failed verification and was quarantined: "
                  f"{reason}", RuntimeWarning, stacklevel=3)
    for path in (_npz_path(ckpt_dir, step), _json_path(ckpt_dir, step)):
        if os.path.exists(path):
            try:
                os.replace(path, path + ".corrupt")
            except OSError:  # pragma: no cover — racing delete
                pass


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _from_numpy(arr: np.ndarray, like):
    """A stored array as a leaf like ``like``: a tensor of its dtype on its
    device, or a host int."""
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, int):
        return int(t)
    raise TypeError(f"a checkpoint restores into tensors and host ints, not {type(like)}")


def _bf16_keys(template: Any) -> frozenset:
    return frozenset(k for k, t in tree_flatten_with_path(template)
                     if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16)


def _build_tree(manifest: dict, data, template: Any):
    tmpl_items = tree_flatten_with_path(template)
    tmpl_keys = [k for k, _ in tmpl_items]
    if tmpl_keys != manifest["keys"]:
        ckpt_keys = set(manifest["keys"])
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  missing: {set(tmpl_keys) - ckpt_keys}\n"
            f"  extra:   {ckpt_keys - set(tmpl_keys)}")
    leaves = []
    for i, (k, t) in enumerate(tmpl_items):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != _shape(t):
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs {_shape(t)}")
        leaves.append(_from_numpy(arr, t))
    return tree_unflatten(template, leaves)


def restore_checkpoint(ckpt_dir: str, template: Any, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``template``.

    With ``step=None`` the newest checkpoint is checked and loaded; a
    damaged one is quarantined with a warning and the walk falls back to
    the next newest.  A pinned ``step`` raises
    :class:`CheckpointCorruptError` on damage.  A structure or shape
    mismatch against ``template`` is a ``ValueError`` (``missing``: the
    template's keys the checkpoint lacks; ``extra``: the reverse)."""
    clean_stale_tmp(ckpt_dir)
    bf16 = _bf16_keys(template)
    if step is not None:
        manifest, data = _read_unit(ckpt_dir, step, bf16)
        return _build_tree(manifest, data, template), step
    candidates = _complete_steps(ckpt_dir)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    for s in reversed(candidates):
        try:
            manifest, data = _read_unit(ckpt_dir, s, bf16)
        except CheckpointCorruptError as e:
            _quarantine(ckpt_dir, s, str(e))
            continue
        return _build_tree(manifest, data, template), s
    raise FileNotFoundError(f"no valid checkpoints in {ckpt_dir} (all candidates quarantined)")

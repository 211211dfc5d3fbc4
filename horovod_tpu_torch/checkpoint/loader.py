"""Elastic resharding checkpoint loader.

Counterpart of ``horovod_tpu/checkpoint/loader.py``: reads a manifest
written at world size N into the current world size M.

Sharded vectors: the manifest records the flat length ``n`` and the old
world's ``(offset, count)`` bounds; :meth:`CheckpointLoader.read_flat`
assembles any window from whichever old shard files overlap it, and the
new rank's window is ``shard_bounds(n, M)[rank]``
(``runtime/sharded.shard_bounds``).

Replicated trees: restored INTO a live target (the state freshly built at
the new world) by the same walk the writer used.  A tensor leaf of the
target is overwritten in place with ``copy_`` (on its device: a
parameter is never rebound); a Python scalar keeps its type; a numpy
leaf is replaced by a new array of its dtype.

bf16: numpy has no bf16 without ``ml_dtypes``, which the port does not
use, so a bf16 array the JAX package wrote reloads as ``|V2``.  Such a
leaf is read as ``uint16`` and viewed as ``torch.bfloat16`` where the
manifest (a sharded entry's dtype) or the target tensor (a replicated
leaf) says bf16; elsewhere it raises.  The port itself writes bf16 as
fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.checkpoint import manifest as mf
from horovod_tpu_torch.checkpoint.manifest import (CheckpointError,
                                                   CheckpointIncompleteError,
                                                   latest_manifest)
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.elastic.state import _scalar_like, _walk
from horovod_tpu_torch.runtime.sharded import shard_bounds

__all__ = ["CheckpointLoader", "as_tensor"]


def _is_v2(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def as_tensor(arr: np.ndarray, dtype: torch.dtype,
              bf16: bool = False) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``.  A ``|V2`` (or, with
    ``bf16``, ``uint16``) array is bf16 data: viewed as ``torch.bfloat16``
    when ``bf16`` or ``dtype`` says so, refused otherwise."""
    arr = np.asarray(arr)
    if _is_v2(arr) or (bf16 and arr.dtype == np.uint16):
        if not (bf16 or dtype == torch.bfloat16):
            raise CheckpointError(
                f"a 2-byte void array ({arr.dtype}) can only be read as "
                f"bf16; the target is {dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(dtype)


class CheckpointLoader:
    """One complete checkpoint, opened for (re)sharded reads.

    >>> loader = CheckpointLoader(directory)            # newest complete
    >>> loader = CheckpointLoader(directory, step=200)  # explicit step
    >>> w = loader.restore_tree(template, "params")
    >>> shard = loader.read_flat("zero.master.0", offset, count)

    Raises :class:`CheckpointIncompleteError` for a torn/stale set and
    ``FileNotFoundError`` when the directory holds no complete checkpoint.
    """

    def __init__(self, directory: str, step: Optional[int] = None):
        self.directory = directory
        if step is None:
            found = latest_manifest(directory)
            if found is None:
                steps = mf.list_manifest_steps(directory)
                if steps:
                    # Manifests exist but none validates: surface the
                    # refusal instead of a generic not-found.
                    man = mf.read_manifest(directory, steps[-1])
                    mf.validate(directory, man)
                raise FileNotFoundError(
                    f"no complete checkpoint in {directory}")
            self.manifest, self.step = found
        else:
            self.manifest = mf.read_manifest(directory, step)
            mf.validate(directory, self.manifest)
            self.step = int(step)
        self.epoch = int(self.manifest.get("epoch", 0))
        self.world_size = int(self.manifest["world_size"])
        self.meta = dict(self.manifest.get("meta") or {})
        self._sharded = {e["name"]: e
                         for e in self.manifest.get("sharded", [])}
        self._npz_cache: Dict[int, np.lib.npyio.NpzFile] = {}
        self._replicated: Optional[Dict[str, np.ndarray]] = None

    # -- file plumbing --

    def _shard_npz(self, rank: int):
        npz = self._npz_cache.get(rank)
        if npz is None:
            path = mf.shard_file(self.directory, self.step, rank,
                                 self.world_size)
            try:
                npz = np.load(path)
            except (OSError, ValueError) as e:
                raise CheckpointIncompleteError(
                    f"shard file {path} vanished or is unreadable "
                    f"mid-restore: {e}") from e
            self._npz_cache[rank] = npz
        return npz

    def close(self) -> None:
        for npz in self._npz_cache.values():
            npz.close()
        self._npz_cache.clear()

    # -- sharded vectors --

    def sharded_names(self):
        return sorted(self._sharded)

    def flat_length(self, name: str) -> int:
        return int(self._sharded[name]["n"])

    def flat_is_bf16(self, name: str) -> bool:
        return self._sharded[name]["dtype"] == "bfloat16"

    def read_flat(self, name: str, offset: int = 0,
                  count: Optional[int] = None) -> np.ndarray:
        """The ``[offset, offset+count)`` window of sharded vector
        ``name``, assembled from the old-world shard files that overlap
        it.  A bf16 entry comes back as its ``uint16`` bits
        (:func:`as_tensor` with ``bf16=True`` makes it a tensor)."""
        entry = self._sharded.get(name)
        if entry is None:
            raise KeyError(
                f"checkpoint step {self.step} has no sharded vector "
                f"'{name}' (has: {self.sharded_names()})")
        n = int(entry["n"])
        if count is None:
            count = n - offset
        end = offset + count
        if not (0 <= offset <= end <= n):
            raise ValueError(
                f"window [{offset}, {end}) out of range for n={n}")
        dtype = (np.dtype(np.uint16) if entry["dtype"] == "bfloat16"
                 else np.dtype(entry["dtype"]))
        parts = []
        for rank, (off, cnt) in enumerate(entry["bounds"]):
            lo, hi = max(offset, off), min(end, off + cnt)
            if lo >= hi:
                continue
            piece = self._shard_npz(rank)[entry["key"]]
            if _is_v2(piece):
                piece = piece.view(np.uint16)
            parts.append(piece[lo - off:hi - off])
        if not parts:
            return np.zeros(0, dtype=dtype)
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return np.ascontiguousarray(out, dtype=dtype)

    def my_flat_shard(self, name: str, rank: int, size: int) -> np.ndarray:
        """Rank ``rank``-of-``size``'s window of ``name`` under the
        largest-first split at the NEW world size."""
        off, cnt = shard_bounds(self.flat_length(name), size)[rank]
        return self.read_flat(name, off, cnt)

    # -- replicated trees --

    def _rep_arrays(self) -> Dict[str, np.ndarray]:
        if self._replicated is None:
            rep = self.manifest.get("replicated") or {}
            npz = self._shard_npz(int(rep.get("file_rank", 0)))
            self._replicated = {
                path: npz[f"rep.{i}"]
                for i, path in enumerate(rep.get("paths", []))
            }
        return self._replicated

    def replicated_paths(self):
        return sorted(self._rep_arrays())

    def read_replicated(self, path: str) -> np.ndarray:
        """The saved replicated array at an exact walk path."""
        rep = self._rep_arrays()
        if path not in rep:
            raise KeyError(
                f"checkpoint step {self.step} has no replicated leaf "
                f"'{path}'")
        return rep[path]

    def slot_names(self):
        """Top-level slot names present in the checkpoint (replicated
        paths' first components plus sharded-name roots)."""
        roots = set()
        for path in self._rep_arrays():
            roots.add(path.split(".", 1)[0])
        for name in self._sharded:
            roots.add(name.split(".", 1)[0])
        return sorted(roots)

    def restore_tree(self, target, prefix: str, *,
                     missing: str = "error"):
        """Rebuild ``target`` (a live tree: the state freshly built at the
        CURRENT world) with every leaf replaced by the checkpointed value
        at the same walk path.

        - a path recorded as a SHARDED vector is filled with this rank's
          window at the new world (the leaf must be that window: 1-D of
          the new count);
        - a replicated path adopts the saved array (shape-checked);
        - a tensor leaf is overwritten in place and returned;
        - ``missing="error"`` raises on a target leaf the checkpoint
          never saved; ``missing="keep"`` keeps the target's value.
        """
        rank = basics.rank() if basics.is_initialized() else 0
        size = basics.size() if basics.is_initialized() else 1
        rep = self._rep_arrays()

        def visit(path, leaf):
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if path in self._sharded:
                off, cnt = shard_bounds(self.flat_length(path),
                                        size)[rank]
                if len(shape) != 1 or shape[0] != cnt:
                    raise CheckpointError(
                        f"target leaf at '{path}' has shape {shape} "
                        f"but rank {rank}/{size} owns a ({cnt},) shard "
                        f"of n={self.flat_length(path)}: was the "
                        "optimizer rebuilt for the current world?")
                return _adopt(leaf, self.read_flat(path, off, cnt),
                              bf16=self.flat_is_bf16(path))
            saved = rep.get(path)
            if saved is None:
                if missing == "keep":
                    return leaf
                raise CheckpointError(
                    f"checkpoint step {self.step} has no value for "
                    f"'{path}' (slots: {self.slot_names()})")
            if saved.ndim == 0 or len(shape) == 0:
                if isinstance(leaf, (bool, int, float)):
                    return _scalar_like(leaf, saved.reshape(())[()])
            elif tuple(saved.shape) != shape:
                raise CheckpointError(
                    f"shape mismatch at '{path}': checkpoint has "
                    f"{tuple(saved.shape)}, target expects {shape}")
            return _adopt(leaf, saved)

        return _walk(target, prefix, visit)


def _adopt(leaf, saved: np.ndarray, bf16: bool = False):
    """``saved`` in the place of ``leaf``: copied into a tensor leaf in
    place, or a new array of a numpy leaf's dtype."""
    if isinstance(leaf, torch.Tensor):
        src = as_tensor(saved, leaf.dtype, bf16=bf16)
        with torch.no_grad():
            leaf.copy_(src.reshape(leaf.shape))
        return leaf
    arr = np.asarray(leaf)
    if _is_v2(saved) or bf16:
        raise CheckpointError(
            f"bf16 data ({saved.dtype}) cannot be restored into a numpy "
            f"{arr.dtype} leaf without ml_dtypes")
    return np.asarray(saved).astype(arr.dtype, copy=False).reshape(
        arr.shape).copy()

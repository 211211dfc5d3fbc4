"""Checkpoint manifest: the commit record of the sharded weight plane.

Counterpart of ``horovod_tpu/checkpoint/manifest.py``, the same format
byte for byte, so either package reads the other's checkpoints.

Layout on disk (``HOROVOD_CHECKPOINT_DIR``)::

    <dir>/ckpt-<step>.manifest.json          # rank 0, tmp+rename, LAST
    <dir>/step-<step>/shard-<r>-of-<N>.npz   # per rank, tmp+rename

Durability contract: a manifest is written by rank 0 ONLY after a
MAX-allreduce barrier confirmed every rank's shard file landed (renamed
into place).  A manifest therefore IMPLIES a complete, loadable shard
set; readers trust nothing else.  Retention deletes in the reverse
order (manifest first, then shards) so the implication survives a crash
mid-cleanup.  A SIGKILL at any instant leaves either the previous
complete set or the new one — a half-written ``.tmp`` shard is invisible
(never renamed) and a shard set without its manifest is ignored.

Manifest fields (format 1):

- ``step`` / ``epoch`` / ``world_size``: the committed training step,
  the membership epoch the save ran under, and the world N it sharded
  across.
- ``shards``: one entry per rank — relative file path and byte size
  (size is re-checked by :func:`validate`, catching truncation).
- ``sharded``: the flat ZeRO vectors — name (a state walk path, see
  loader), total length ``n``, dtype, npz key, and the per-rank
  ``(offset, count)`` bounds at world N.  A world-M restore re-slices
  these through ``shard_bounds(n, M)`` — the resize semantics that pair
  with ``ShardResizeError``.
- ``replicated``: the walk paths of the replicated pytree leaves, all
  stored in rank 0's shard file (identical on every rank, so one copy).
- ``meta``: caller dict (e.g. ``{"model": "tiny"}`` for serve).
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Tuple

__all__ = [
    "FORMAT_VERSION", "CheckpointError", "CheckpointIncompleteError",
    "manifest_path", "shard_dir", "shard_file", "list_manifest_steps",
    "read_manifest", "validate", "latest_manifest",
]

FORMAT_VERSION = 1

_MANIFEST_RE = re.compile(r"^ckpt-(\d+)\.manifest\.json$")


class CheckpointError(RuntimeError):
    """Malformed or unreadable checkpoint data."""


class CheckpointIncompleteError(CheckpointError):
    """A manifest references shard files that are missing or truncated:
    the set is incomplete (e.g. hand-deleted shards, a non-shared
    filesystem, or a manifest copied without its shard directory).
    Loaders refuse it rather than resume from a torn mix; pick an older
    complete set via :func:`latest_manifest`."""


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-{int(step)}.manifest.json")


def shard_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step-{int(step)}")


def shard_file(directory: str, step: int, rank: int, size: int) -> str:
    return os.path.join(shard_dir(directory, step),
                        f"shard-{int(rank)}-of-{int(size)}.npz")


def list_manifest_steps(directory: str) -> List[int]:
    """Steps with a manifest file present, ascending (completeness NOT
    checked — see :func:`validate` / :func:`latest_manifest`)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def read_manifest(directory: str, step: int) -> dict:
    path = manifest_path(directory, step)
    try:
        with open(path, "r", encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest {path}: {e}") from e
    if not isinstance(man, dict) or man.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"manifest {path} has unsupported format "
            f"{man.get('format') if isinstance(man, dict) else man!r} "
            f"(want {FORMAT_VERSION})")
    return man


def validate(directory: str, man: dict) -> None:
    """Raise :class:`CheckpointIncompleteError` unless every shard file
    the manifest references exists with the recorded byte size."""
    missing = []
    for entry in man.get("shards", []):
        path = os.path.join(directory, entry["file"])
        try:
            actual = os.path.getsize(path)
        except OSError:
            missing.append(f"{entry['file']} (missing)")
            continue
        if int(entry.get("bytes", -1)) not in (-1, actual):
            missing.append(
                f"{entry['file']} (truncated: {actual} != "
                f"{entry['bytes']} bytes)")
    if missing:
        raise CheckpointIncompleteError(
            f"checkpoint step {man.get('step')} in {directory} is "
            f"incomplete — refusing to load a torn set: "
            + ", ".join(missing)
            + ". Delete the stale manifest (or restore the missing "
            "shards) to fall back to the previous complete checkpoint.")


def latest_manifest(directory: str) -> Optional[Tuple[dict, int]]:
    """The newest COMPLETE checkpoint: scan manifests newest-first,
    skip any whose shard set fails :func:`validate` (a stale manifest
    must never mask an older loadable set), return ``(manifest, step)``
    or ``None``."""
    for step in reversed(list_manifest_steps(directory)):
        try:
            man = read_manifest(directory, step)
            validate(directory, man)
        except CheckpointError:
            continue
        return man, step
    return None

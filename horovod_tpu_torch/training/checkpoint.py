"""Checkpoint / resume: the rank-0-writes, broadcast-on-resume pattern.

Counterpart of ``horovod_tpu/flax/checkpoint.py``.  Rank 0 alone writes,
the resume epoch is found on rank 0 and broadcast, and the restored state
reaches every rank by broadcast.  The reference writes flax msgpack; the
port writes ``checkpoint-{epoch}.pt`` with ``torch.save`` (the card's
machine has neither flax nor msgpack): CPU tensors, read back with
``weights_only=True`` into the target's structure and device.  The two
packages' per-epoch checkpoints therefore do not cross (a pinned
difference, ROADMAP.md Queue C); their sharded ones do.

A state is a :class:`~horovod_tpu_torch.training.TrainState` (its model's
state dict, its optimizer's state and its step), a module, or a nest of
dicts, lists and tuples of tensors and numbers.  Restores
copy into the target's tensors in place and return the target.

``save_sharded`` / ``restore_sharded`` / ``latest_sharded`` keep each
rank's shards apart without gathering them, over the port's weight plane
(``checkpoint/``: the writer's per-rank shards, commit barrier and
manifest, the loader's resharding restore) in ``sharded-{step}``
directories.  Every rank calls them.
"""

from __future__ import annotations

import io
import os
import re
from typing import Any, Optional, Tuple

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.training.state import TrainState

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "resume_epoch",
    "restore_and_broadcast",
    "save_sharded",
    "restore_sharded",
    "latest_sharded",
]


def _ckpt_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"checkpoint-{epoch}.pt")


def _unwrap(optimizer):
    """The optimizer that holds the state under a JAX-form
    ``DistributedOptimizer``: its ZeRO rung, else its inner optimizer."""
    from horovod_tpu_torch.frontend import DistributedOptimizer

    if isinstance(optimizer, DistributedOptimizer):
        return optimizer.zero or optimizer.inner
    return optimizer


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _optimizer_state(optimizer) -> dict:
    opt = _unwrap(optimizer)
    if hasattr(opt, "masters"):             # MasterWeights
        return {"masters": _to_cpu(list(opt.masters)),
                "inner": _to_cpu(opt.inner.state_dict())}
    return _to_cpu(opt.state_dict())


def _load_optimizer(optimizer, saved: dict) -> None:
    opt = _unwrap(optimizer)
    if hasattr(opt, "masters"):
        with torch.no_grad():
            for m, s in zip(opt.masters, saved["masters"]):
                m.copy_(s)
        opt.inner.load_state_dict(saved["inner"])
        opt.rederive()
        return
    opt.load_state_dict(saved)


def _saveable(state) -> Any:
    """``state`` as CPU tensors in plain containers."""
    if isinstance(state, TrainState):
        return {"model": _to_cpu(state.model.state_dict()),
                "optimizer": _optimizer_state(state.optimizer),
                "step": int(state.step)}
    if isinstance(state, torch.nn.Module):
        return _to_cpu(state.state_dict())
    return _to_cpu(state)


def _load_into(target, saved):
    """``saved`` into ``target``'s structure: tensors copied in place
    (onto the target's device and dtype), numbers replaced."""
    if isinstance(target, TrainState):
        target.model.load_state_dict(saved["model"])
        _load_optimizer(target.optimizer, saved["optimizer"])
        target.step = int(saved["step"])
        return target
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        for k in target:
            target[k] = _load_into(target[k], saved[k])
        return target
    if isinstance(target, (list, tuple)):
        return type(target)(_load_into(t, s) for t, s in zip(target, saved))
    return saved


def save_checkpoint(directory: str, state: Any, epoch: int,
                    *, only_rank0: bool = True) -> Optional[str]:
    """Write ``state`` for ``epoch`` to ``checkpoint-{epoch}.pt``, through
    a tmp file and ``os.replace`` (a resume never sees a partial file).
    On rank 0 only by default; returns the path (None on the other
    ranks)."""
    if only_rank0 and basics.rank() != 0:
        return None
    os.makedirs(directory, exist_ok=True)
    path = _ckpt_path(directory, epoch)
    tmp = path + ".tmp"
    torch.save(_saveable(state), tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str) -> Optional[Tuple[str, int]]:
    """(path, epoch) of the newest checkpoint, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for fname in os.listdir(directory):
        m = re.fullmatch(r"checkpoint-(\d+)\.pt", fname)
        if m:
            epoch = int(m.group(1))
            if best is None or epoch > best[1]:
                best = (os.path.join(directory, fname), epoch)
    return best


def _read(source) -> Any:
    return torch.load(source, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, target: Any) -> Any:
    """Read ``path`` into ``target`` (in place; returns it)."""
    return _load_into(target, _read(path))


def resume_epoch(directory: str) -> int:
    """The epoch to resume at, found on rank 0 and broadcast so that every
    rank agrees even when the filesystem is not shared; 0 when starting
    fresh."""
    from horovod_tpu_torch.runtime import eager

    found = latest_checkpoint(directory) if basics.rank() == 0 else None
    epoch = 0 if found is None else found[1] + 1
    agreed = eager.broadcast(torch.tensor([epoch], dtype=torch.int32),
                             root_rank=0, name="resume_epoch")
    return int(agreed[0])


def _broadcast_bytes(payload: Optional[bytes], root_rank: int) -> bytes:
    """Root's ``payload`` on every rank (its length first)."""
    from horovod_tpu_torch.runtime import eager

    n = torch.tensor([0 if payload is None else len(payload)],
                     dtype=torch.int64)
    n = int(eager.broadcast(n, root_rank, name="ckpt.bytes.n")[0])
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8)
           if payload is not None else torch.zeros(n, dtype=torch.uint8))
    return eager.broadcast(buf, root_rank, name="ckpt.bytes").numpy()\
        .tobytes()


def restore_and_broadcast(directory: str, target: Any, *,
                          root_rank: int = 0) -> Tuple[Any, int]:
    """Full resume: ``root_rank`` reads the newest checkpoint, every rank
    receives its bytes by broadcast and loads them into ``target``, and
    the next epoch is agreed globally.  Returns ``(target, start_epoch)``;
    ``(target, 0)`` untouched if there is no checkpoint."""
    start_epoch = resume_epoch(directory)
    if start_epoch == 0:
        return target, 0
    payload = None
    if basics.rank() == root_rank:
        with open(latest_checkpoint(directory)[0], "rb") as f:
            payload = f.read()
    if basics.size() > 1:
        payload = _broadcast_bytes(payload, root_rank)
    return _load_into(target, _read(io.BytesIO(payload))), start_epoch


# ---------------------------------------------------------------------------
# Sharded checkpoints over the weight plane
# ---------------------------------------------------------------------------

def _sharded_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"sharded-{step}")


def save_sharded(directory: str, state: Any, step: int) -> str:
    """Checkpoint ``state`` at ``step`` into ``sharded-{step}`` without
    gathering: each rank writes its own shard (a ZeRO-1 or FSDP
    optimizer's master and state shards as flat vectors, the rest
    replicated), rank 0 commits the manifest after the engine's commit
    barrier.  A :class:`TrainState` goes as ``checkpoint.torch_capture``
    lays it out; any other nest of tensors under the slot ``state``.
    Every rank calls it; returns the directory."""
    from horovod_tpu_torch.checkpoint import CheckpointWriter, torch_capture

    if isinstance(state, TrainState):
        tree, sharded = torch_capture(_unwrap(state.optimizer), state.model,
                                      step)
    else:
        tree, sharded = {"state": state, "step": int(step)}, {}
    path = _sharded_path(directory, step)
    writer = CheckpointWriter(path)
    try:
        writer.save(step, tree, sharded)
        writer.wait()
    finally:
        writer.close()
    return path


def restore_sharded(directory: str, target: Any,
                    step: Optional[int] = None):
    """Restore a sharded checkpoint INTO ``target`` (built for the current
    world: a resized world reslices the flat vectors), in place.  ``step``
    defaults to the newest.  Returns ``(target, step)``, or ``(target,
    None)`` when there is no sharded checkpoint."""
    from horovod_tpu_torch.checkpoint import CheckpointLoader, torch_restore

    if step is None:
        found = latest_sharded(directory)
        if found is None:
            return target, None
        step = found[1]
    loader = CheckpointLoader(_sharded_path(directory, step))
    try:
        if isinstance(target, TrainState):
            target.step = torch_restore(_unwrap(target.optimizer),
                                        target.model, loader)
        else:
            target = loader.restore_tree(target, "state")
    finally:
        loader.close()
    return target, step


def latest_sharded(directory: str) -> Optional[Tuple[str, int]]:
    """(path, step) of the newest sharded checkpoint, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for fname in os.listdir(directory):
        m = re.fullmatch(r"sharded-(\d+)", fname)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(directory, fname), step)
    return best

"""Frontend adapters: the port's optimizers and models ↔ the weight plane.

Counterpart of ``horovod_tpu/checkpoint/frontend.py``.  The writer and
loader speak replicated trees + flat sharded vectors; these helpers put
each frontend's state into that vocabulary.

* :func:`torch_capture` / :func:`torch_restore`: the hook form
  (``torch_frontend.DistributedOptimizer``: the mixin over a torch
  optimizer, ZeRO-1 ``sharded=True`` and FSDP ``fsdp=True``), under the
  reference's slot names and walk paths: ``model``, ``torch_opt``,
  ``zero.master.<g>``, ``zero.opt.<g>.<key>``, ``zero_scalars``.  Where
  the reference's ``torch_capture`` can run (fp32 CPU tensors) the
  arrays and paths are the same; the port also takes bf16 (written as
  fp32) and CUDA tensors (through the writer's snapshot).
* :func:`jax_capture` / :func:`jax_restore`: the port's JAX-form
  ``frontend.DistributedOptimizer`` on a model of the port.  The
  ``params`` slot is written in the JAX package's flax paths and
  ``[in, out]`` layout (``models/convert.jax_tree``), so the JAX loader,
  the JAX serve replica and the port's serve replica all read it; the
  optimizer state stays in its torch form (``torch_opt`` or the ZeRO
  slots), as the hook form writes it.

Restores overwrite the live tensors in place (``copy_``): a parameter is
never rebound.  ``step`` of a restored torch optimizer state is a 0-d
tensor, as torch keeps it (the reference restores a Python number,
which ``torch.optim.AdamW`` does not advance).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.checkpoint.loader import CheckpointLoader, as_tensor

__all__ = ["jax_capture", "jax_restore", "torch_capture", "torch_restore"]


def _shard_groups(opt):
    """(group, inner param, sharder) triples of a ZeRO-1 or FSDP
    optimizer (the object with ``_groups`` and ``_shard_opt``), or None
    for a plain / hook-wrapped one."""
    groups = getattr(opt, "_groups", None)
    shard_opt = getattr(opt, "_shard_opt", None)
    if not groups or shard_opt is None:
        return None
    plane = getattr(opt, "plane", None)
    out = []
    for gi, g in enumerate(groups):
        sharder = g.get("sharder") or plane.units[gi].sharder
        out.append((g, shard_opt.param_groups[gi]["params"][0], sharder))
    return out


def _torch_opt_state(opt):
    """A plain optimizer's state in its torch form (``MasterWeights``:
    its masters and its inner optimizer's state dict)."""
    if hasattr(opt, "state_dict"):
        return opt.state_dict()
    return {"masters": list(opt.masters), "inner": opt.inner.state_dict()}


def _capture_optimizer(opt, state: dict):
    """The optimizer's slots into ``state``; returns the sharded map."""
    sharded: Dict[str, Tuple[object, int]] = {}
    triples = _shard_groups(opt)
    if triples is None:
        # Unsharded: every rank holds the same state after the averaged
        # step, so it rides the replicated tree.
        state["torch_opt"] = _torch_opt_state(opt)
        return sharded
    scalars: Dict[str, object] = {}
    for gi, (g, inner_param, sh) in enumerate(triples):
        sharded[f"zero.master.{gi}"] = (g["master"].detach(), sh.n)
        for key, val in opt._shard_opt.state.get(inner_param, {}).items():
            if torch.is_tensor(val) and val.numel() == sh.count:
                sharded[f"zero.opt.{gi}.{key}"] = (
                    val.detach().to(torch.float32), sh.n)
            else:
                scalars[f"{gi}.{key}"] = (
                    val.item() if torch.is_tensor(val) else val)
    state["zero_scalars"] = scalars
    return sharded


def torch_capture(opt, model, step: int, extra: Optional[dict] = None):
    """``(state, sharded)`` for ``CheckpointWriter.save`` from a hook-form
    optimizer (ZeRO-1, FSDP, or the plain mixin) and its model."""
    state = {"model": {k: v.detach() for k, v in
                       model.state_dict().items()},
             "step": int(step)}
    if extra:
        state.update(extra)
    return state, _capture_optimizer(opt, state)


def _state_value(key: str, val, old):
    """A restored per-parameter optimizer state entry: a tensor where one
    lives (and always for ``step``), else a Python scalar."""
    arr = np.asarray(val)
    if arr.ndim:
        return torch.from_numpy(np.ascontiguousarray(arr).copy())
    if isinstance(old, torch.Tensor):
        return torch.tensor(arr[()].item(), dtype=old.dtype,
                            device=old.device)
    if key == "step":
        return torch.tensor(arr[()].item(), dtype=torch.get_default_dtype())
    return arr[()].item()


def _restore_plain(opt, loader: CheckpointLoader, slot: str) -> None:
    """Load a plain optimizer's torch-form state from ``slot``: a
    never-stepped optimizer has no per-parameter entries to walk, so the
    entries are rebuilt from the saved paths."""
    if not hasattr(opt, "state_dict"):       # MasterWeights
        loader.restore_tree({"masters": list(opt.masters)}, slot,
                            missing="keep")
        _restore_plain(opt.inner, loader, f"{slot}.inner")
        return
    sd = loader.restore_tree(opt.state_dict(), slot, missing="keep")
    pref = f"{slot}.state."
    old_state = opt.state_dict()["state"]
    st: Dict[int, dict] = {}
    for p in loader.replicated_paths():
        if not p.startswith(pref):
            continue
        idx, _, key = p[len(pref):].partition(".")
        old = old_state.get(int(idx), {}).get(key)
        st.setdefault(int(idx), {})[key] = _state_value(
            key, loader.read_replicated(p), old)
    sd["state"] = st
    opt.load_state_dict(sd)


def _restore_optimizer(opt, loader: CheckpointLoader) -> None:
    triples = _shard_groups(opt)
    if triples is None:
        if "torch_opt" in loader.slot_names():
            _restore_plain(opt, loader, "torch_opt")
        return
    from horovod_tpu_torch.torch_frontend import _copy_flat_into

    scalar_prefix = "zero_scalars."
    scalars = {p[len(scalar_prefix):]: loader.read_replicated(p)
               for p in loader.replicated_paths()
               if p.startswith(scalar_prefix)}
    for gi, (g, inner_param, sh) in enumerate(triples):
        master = g["master"]
        name = f"zero.master.{gi}"
        with torch.no_grad():
            master.copy_(as_tensor(
                loader.read_flat(name, sh.offset, sh.count), master.dtype,
                bf16=loader.flat_is_bf16(name)))
        st = opt._shard_opt.state.setdefault(inner_param, {})
        prefix = f"zero.opt.{gi}."
        for name in loader.sharded_names():
            if not name.startswith(prefix):
                continue
            key = name[len(prefix):]
            val = as_tensor(loader.read_flat(name, sh.offset, sh.count),
                            master.dtype, bf16=loader.flat_is_bf16(name))
            old = st.get(key)
            if isinstance(old, torch.Tensor) and old.shape == val.shape:
                with torch.no_grad():
                    old.copy_(val)
            else:
                st[key] = val.to(master.device)
        for skey, val in scalars.items():
            sgi, _, key = skey.partition(".")
            if int(sgi) == gi:
                st[key] = _state_value(key, val, st.get(key))
        # The fp32 master is authoritative: the params follow it through
        # the allgather the step uses, so every rank's params agree.
        _copy_flat_into(sh.gather_updates(master.detach()), g["params"],
                        g["shapes"])
    plane = getattr(opt, "plane", None)
    if plane is not None:
        for i in range(plane.n_units):
            plane.free(i)


def _step_of(loader: CheckpointLoader, step_slot: str) -> int:
    return int(np.asarray(loader.read_replicated(step_slot)))


def torch_restore(opt, model, loader: CheckpointLoader,
                  step_slot: str = "step") -> int:
    """Fill ``model`` and ``opt`` (built for the CURRENT world) in place
    from the checkpoint; returns the restored step.  Sharded masters and
    per-element optimizer state are resliced through the new world's
    bounds; optimizer state entries a never-stepped optimizer lacks are
    made."""
    loader.restore_tree(model.state_dict(), "model")
    _restore_optimizer(opt, loader)
    return _step_of(loader, step_slot)


def jax_capture(opt, model, step: int, extra: Optional[dict] = None):
    """``(state, sharded)`` from the port's JAX-form
    ``DistributedOptimizer`` (ZeRO-1 or not; None: the weights alone, as
    a serving checkpoint) and a model of the port: the ``params`` slot in
    the JAX package's flax paths and layout (tensors; bf16 written as
    fp32), the optimizer state in its torch form."""
    from horovod_tpu_torch.models.convert import jax_tree

    state = {"params": jax_tree(model.state_dict(), model.config)["params"],
             "step": int(step)}
    if extra:
        state.update(extra)
    if opt is None:
        return state, {}
    return state, _capture_optimizer(opt.zero or opt.inner, state)


def jax_restore(opt, model, loader: CheckpointLoader,
                step_slot: str = "step") -> int:
    """Fill ``model`` (from the flax-path ``params`` slot) and the JAX-form
    ``opt`` in place at the CURRENT world; returns the restored step."""
    from horovod_tpu_torch.models.convert import jax_tree

    loader.restore_tree(jax_tree(model.state_dict(), model.config)["params"],
                        "params")
    _restore_optimizer(opt.zero or opt.inner, loader)
    return _step_of(loader, step_slot)

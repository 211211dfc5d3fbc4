"""Live trainer→serve weight push: wire codec + pusher client.

Counterpart of ``horovod_tpu/checkpoint/push.py``, producing the same
frames byte for byte, so the reference's ``WeightPusher`` and this one
can drive either fleet.  The trainer ships a model tree to the serve
router as ONE JSON-lines ``weights`` frame; the router fans it out to
every replica (and replays the latest frame to a relaunched replica);
each replica swaps it in between decode steps under a monotonic
generation epoch (``serve/scheduler.py`` ``swap_weights``).

The wire rules are the reference's: small or 0-1-D leaves (norm scales,
biases: the "pinned" class) and non-float leaves ride fp32 or raw; bulk
float matrices ride the requested wire (``int8`` absmax-scaled by
default, ``bf16``, ``fp8`` e4m3 absmax-scaled, ``fp32`` lossless).  The
bf16 and fp8 casts are torch's (``torch.bfloat16``,
``torch.float8_e4m3fn``, round to nearest even), not ``ml_dtypes``.
Decode reconstructs float32; the replica casts into its own dtype.

Leaves may be numpy arrays or torch tensors on any device.  A bf16 tensor
is what numpy (with ``ml_dtypes``) calls a non-float leaf, so it rides
``raw`` with dtype ``bfloat16``, as the reference ships a bf16 array;
its decode is the exact fp32 upcast.

A push is one JSON line, and both packages' serve protocols cap a line
at 64 MiB (``1 << 26`` bytes): push partial trees of full-width models.
Engine-free: the push rides the serve plane's TCP protocol.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.checkpoint.stats import note_weight_push
from horovod_tpu_torch.elastic.state import _walk

__all__ = [
    "PIN_MIN_ELEMS", "encode_leaves", "decode_leaves", "apply_leaves",
    "WeightPusher",
]

#: Leaves below this element count stay fp32 on the wire (the pinned
#: class of the wire-policy rules).
PIN_MIN_ELEMS = 2048

_WIRES = ("fp32", "bf16", "fp8", "int8")


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(
        "ascii")


def _unb64(data: str, dtype, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(data),
                         dtype=dtype).reshape(shape).copy()


def _torch_cast_bits(x: np.ndarray, dtype: torch.dtype,
                     bits) -> np.ndarray:
    """fp32 ``x`` cast to a torch float type, as its raw bits."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).view(
        bits).numpy()


def _bits_to_f32(data: str, shape, dtype: torch.dtype, bits) -> np.ndarray:
    raw = np.frombuffer(base64.b64decode(data), dtype=bits).reshape(shape)
    return torch.from_numpy(raw.copy()).view(dtype).float().numpy()


def _host_leaf(leaf):
    """(array, dtype name) of a leaf; a bf16 tensor as its uint16 bits
    under the name ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def encode_leaves(tree, *, wire: str = "int8",
                  min_elems: int = PIN_MIN_ELEMS) -> List[dict]:
    """Per-leaf wire frames for every leaf of ``tree`` (walked in the
    deterministic sorted-key order, paths rooted at ``w``).  Non-float
    leaves are shipped verbatim (``raw``)."""
    if wire not in _WIRES:
        raise ValueError(f"wire {wire!r} not in {_WIRES}")
    frames: List[dict] = []

    def visit(path, leaf):
        arr, dtype = _host_leaf(leaf)
        frame = {"path": path, "shape": list(arr.shape), "dtype": dtype}
        floating = dtype != "bfloat16" and np.issubdtype(arr.dtype,
                                                          np.floating)
        pinned = not floating or arr.ndim <= 1 or arr.size < min_elems
        w = "fp32" if pinned or wire == "fp32" else wire
        x = arr.astype(np.float32, copy=False) if floating else arr
        if w == "fp32":
            frame.update(wire="fp32", data=_b64(x))
            if not floating:
                frame["wire"] = "raw"
        elif w == "bf16":
            frame.update(wire="bf16", data=_b64(
                _torch_cast_bits(x, torch.bfloat16, torch.int16)))
        elif w == "fp8":
            absmax = float(np.max(np.abs(x))) if x.size else 0.0
            scale = absmax / 448.0 if absmax > 0 else 1.0
            frame.update(wire="fp8", scale=scale, data=_b64(
                _torch_cast_bits(x / scale, torch.float8_e4m3fn,
                                 torch.uint8)))
        else:  # int8 absmax
            absmax = float(np.max(np.abs(x))) if x.size else 0.0
            scale = absmax / 127.0 if absmax > 0 else 1.0
            frame.update(wire="int8", scale=scale, data=_b64(
                np.clip(np.rint(x / scale), -127, 127).astype(np.int8)))
        frames.append(frame)
        return leaf

    _walk(tree, "w", visit)
    return frames


def decode_leaves(frames: List[dict]) -> Dict[str, np.ndarray]:
    """``{path: array}``: float wires reconstruct float32, ``raw`` keeps
    the original dtype (bf16 raw comes back as its exact fp32)."""
    out: Dict[str, np.ndarray] = {}
    for f in frames:
        shape = tuple(f["shape"])
        w = f["wire"]
        if w == "raw":
            if f["dtype"] == "bfloat16":
                arr = _bits_to_f32(f["data"], shape, torch.bfloat16,
                                   np.int16)
            else:
                arr = _unb64(f["data"], np.dtype(f["dtype"]), shape)
        elif w == "fp32":
            arr = _unb64(f["data"], np.float32, shape)
        elif w == "bf16":
            arr = _bits_to_f32(f["data"], shape, torch.bfloat16, np.int16)
        elif w == "fp8":
            arr = _bits_to_f32(f["data"], shape, torch.float8_e4m3fn,
                               np.uint8) * f.get("scale", 1.0)
            arr = arr.astype(np.float32)
        elif w == "int8":
            arr = (_unb64(f["data"], np.int8, shape).astype(np.float32)
                   * f.get("scale", 1.0)).astype(np.float32)
        else:
            raise ValueError(f"unknown wire {w!r} in weights frame")
        out[f["path"]] = arr
    return out


def apply_leaves(target, by_path: Dict[str, np.ndarray]):
    """Rebuild ``target`` with every leaf whose walk path appears in
    ``by_path`` replaced, cast to the leaf's dtype (a tensor leaf is
    overwritten in place); untouched leaves pass through, so a partial
    push updates only what it carries."""
    def visit(path, leaf):
        new = by_path.get(path)
        if new is None:
            return leaf
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(new.shape) != shape:
            raise ValueError(
                f"weights push leaf '{path}' has shape "
                f"{tuple(new.shape)}, replica expects {shape}"
                " — pushed model does not match the serving model")
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(np.ascontiguousarray(new)))
            return leaf
        return np.asarray(new).astype(np.asarray(leaf).dtype, copy=False)

    return _walk(target, "w", visit)


class WeightPusher:
    """Trainer-side client: encode the model tree and push it to the
    serve router (which fans out to every replica and caches the frame
    for rejoins).

    >>> pusher = WeightPusher("127.0.0.1", router_port)
    >>> ack = pusher.push(tree)           # epoch auto-increments
    >>> pusher.close()
    """

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        from horovod_tpu_torch.serve.server import ServeClient

        self._cli = ServeClient(host, port, timeout=timeout)
        self._epoch = 0

    def push(self, tree, *, epoch: Optional[int] = None,
             wire: str = "int8", min_elems: int = PIN_MIN_ELEMS) -> dict:
        if epoch is None:
            self._epoch += 1
            epoch = self._epoch
        else:
            self._epoch = int(epoch)
        frames = encode_leaves(tree, wire=wire, min_elems=min_elems)
        ack = self._cli.push_weights(frames, epoch)
        note_weight_push()
        return ack

    def close(self) -> None:
        self._cli.close()

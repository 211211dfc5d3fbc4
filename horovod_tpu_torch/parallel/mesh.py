"""Device-mesh construction: the named axes as a torch ``DeviceMesh``.

Counterpart of ``horovod_tpu/parallel/mesh.py``.  Where the reference
arranges ``jax.devices()`` into a ``jax.sharding.Mesh``, the port lays the
ranks of the default process group (``hvd.init()``, one process per GPU)
out as a ``DeviceMesh`` with the same axis names and sizes; axis order is
the reference's (later axes innermost).  The axis names follow the same
convention:

  ``data``    — pure data parallelism (gradient averaging)
  ``fsdp``    — data parallelism with sharded parameters and optimizer state
  ``tensor``  — tensor/model parallelism
  ``seq``     — sequence/context parallelism
  ``expert``  — expert parallelism for MoE layers

The reference's thread-local default mesh (``default_mesh``,
``use_mesh``) is not ported: every function here takes its mesh.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from horovod_tpu_torch.common import basics

__all__ = ["AXIS_DATA", "AXIS_FSDP", "AXIS_TENSOR", "AXIS_SEQ", "AXIS_EXPERT",
           "build_mesh", "mesh_axis_size", "axis_sizes", "data_axes"]

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

# Axes over which gradients are reduced (batch-like axes).
_DATA_LIKE_AXES = (AXIS_DATA, AXIS_FSDP)


def _resolve_shape(axes: Mapping[str, int], n_devices: int) -> Dict[str, int]:
    """Fill in a single -1 wildcard so the product equals n_devices."""
    shape = dict(axes)
    wild = [k for k, v in shape.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(v for v in shape.values() if v != -1)
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(
                f"cannot infer axis {wild[0]!r}: {n_devices} devices not "
                f"divisible by {fixed}"
            )
        shape[wild[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(
            f"mesh shape {shape} does not cover {n_devices} devices"
        )
    return shape


def build_mesh(axes: Optional[Mapping[str, int]] = None) -> DeviceMesh:
    """A ``DeviceMesh`` with named axes over every rank of the default
    process group, on the device type ``hvd.init()`` bound (raises before
    it).  ``axes`` maps axis name -> size with at most one ``-1``
    wildcard, e.g. ``{"data": 1, "fsdp": -1}``; default: every rank on
    ``data``."""
    n = basics.size()
    if axes is None:
        axes = {AXIS_DATA: n}
    shape = _resolve_shape(axes, n)
    names = tuple(shape)
    return init_device_mesh(basics.device().type,
                            tuple(shape[a] for a in names),
                            mesh_dim_names=names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a plain mapping, which
    stands for one: rule checks need only the names and sizes)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(axis_name, mesh) -> int:
    """Size of one axis, or the product over a tuple/list of axes."""
    sizes = axis_sizes(mesh)
    if isinstance(axis_name, (tuple, list)):
        return math.prod(sizes[a] for a in axis_name)
    return sizes[axis_name]


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-like axes of ``mesh`` (gradient-reduction axes)."""
    return tuple(a for a in axis_sizes(mesh) if a in _DATA_LIKE_AXES)

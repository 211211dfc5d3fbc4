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
  ``pipe``    — pipeline stages (``parallel/pipeline.py``)

As in the reference, a thread-local default mesh (:func:`default_mesh`,
:func:`set_default_mesh`, :func:`use_mesh`) stands in where a function
is not given one; the first use builds :func:`data_parallel_mesh`.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from horovod_tpu_torch.common import basics

__all__ = ["AXIS_DATA", "AXIS_FSDP", "AXIS_TENSOR", "AXIS_SEQ", "AXIS_EXPERT",
           "AXIS_PIPE", "build_mesh", "data_parallel_mesh", "default_mesh",
           "current_mesh", "set_default_mesh", "use_mesh", "mesh_axis_size",
           "axis_sizes", "data_axes", "axis_index"]

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"

# Axes over which gradients are reduced (batch-like axes).
_DATA_LIKE_AXES = (AXIS_DATA, AXIS_FSDP)

_state = threading.local()


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


def data_parallel_mesh() -> DeviceMesh:
    """The default Horovod-like topology: every rank on one ``data``
    axis."""
    return build_mesh({AXIS_DATA: -1})


def default_mesh() -> DeviceMesh:
    """The active mesh, building a data-parallel one on first use."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        mesh = data_parallel_mesh()
        _state.mesh = mesh
    return mesh


def current_mesh() -> Optional[DeviceMesh]:
    """The mesh set (by :func:`use_mesh`, :func:`set_default_mesh` or a
    first :func:`default_mesh`), or None; builds none."""
    return getattr(_state, "mesh", None)


def set_default_mesh(mesh: Optional[DeviceMesh]) -> None:
    _state.mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Context manager installing ``mesh`` as the default."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of a plain mapping, which
    stands for one: rule checks need only the names and sizes)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(axis_name, mesh=None) -> int:
    """Size of one axis, or the product over a tuple/list of axes."""
    sizes = axis_sizes(mesh if mesh is not None else default_mesh())
    if isinstance(axis_name, (tuple, list)):
        return math.prod(sizes[a] for a in axis_name)
    return sizes[axis_name]


def data_axes(mesh=None) -> Tuple[str, ...]:
    """The batch-like axes of ``mesh`` (gradient-reduction axes)."""
    mesh = mesh if mesh is not None else default_mesh()
    return tuple(a for a in axis_sizes(mesh) if a in _DATA_LIKE_AXES)


def axis_index(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's index over ``axes`` taken together, the first axis
    outermost (how the reference's ``P(("data", "fsdp"))`` lays a batch
    over them); 0 for no axes."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return idx


# A default mesh's groups go with the world that made them.
basics.on_shutdown(lambda: set_default_mesh(None))

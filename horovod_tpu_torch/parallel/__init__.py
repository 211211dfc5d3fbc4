"""Meshes and the parallelism families (counterparts of
``horovod_tpu/parallel/``): the named mesh as a torch ``DeviceMesh`` and
the default-mesh helpers (``mesh.py``); the reference's sharding rules,
tensor/expert/fsdp placement and ``make_parallel_train_step``
(``api.py``, ``placement.py``); the families' differentiable collectives
(``comm.py``); ring and Ulysses attention (``ring_attention.py``) and the
context-parallel step (``seq.py``); and the GPipe pipeline
(``pipeline.py``).  The mesh helpers are re-exported here, as the
reference's ``horovod_tpu/parallel/__init__`` does."""

from horovod_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,
                                             AXIS_FSDP, AXIS_SEQ,
                                             AXIS_TENSOR, build_mesh,
                                             data_axes, data_parallel_mesh,
                                             default_mesh, mesh_axis_size,
                                             set_default_mesh, use_mesh)

__all__ = ["AXIS_DATA", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_SEQ",
           "AXIS_TENSOR", "build_mesh", "data_axes", "data_parallel_mesh",
           "default_mesh", "mesh_axis_size", "set_default_mesh", "use_mesh"]

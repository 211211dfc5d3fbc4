"""Meshes and the parallelism families (counterparts of
``horovod_tpu/parallel/``): the named mesh as a torch ``DeviceMesh`` and
the default-mesh helpers (``mesh.py``); the reference's sharding rules,
tensor/expert/fsdp placement and ``make_parallel_train_step``
(``api.py``, ``placement.py``); the families' differentiable collectives
(``comm.py``); ring and Ulysses attention (``ring_attention.py``) and the
context-parallel step (``seq.py``); and the GPipe pipeline
(``pipeline.py``)."""

"""Meshes and parameter placement (counterparts of
``horovod_tpu/parallel/``): the named ``data``/``fsdp`` mesh as a torch
``DeviceMesh`` and the reference's sharding rules applied with FSDP2.
The tensor, sequence and expert families are not ported yet (ROADMAP.md
Queue A item 9)."""

"""Host-side runtime: the eager native engine's binding, the staging of
CUDA tensors, the eager collectives over them, and the planes above them:
ZeRO-1 (``sharded``), FSDP units (``fsdp``), top-k sparse allreduce
(``sparse``), the wire policy (``wire_policy``) and the expert-parallel
MoE layer (``moe``)."""


def engine_or_none():
    """The native engine, or None at ``size() == 1``, where every eager
    collective is an identity (the reference's ``engine_or_none``)."""
    from horovod_tpu_torch.common import basics

    if basics.size() == 1:
        return None
    from horovod_tpu_torch.runtime.engine import get_engine

    return get_engine()

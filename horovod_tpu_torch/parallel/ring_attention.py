"""Ring attention and Ulysses: attention over a sequence sharded on a mesh
axis.

Counterpart of ``horovod_tpu/parallel/ring_attention.py``.  Shard ``i`` of
the ``seq`` axis holds positions ``[i*S_loc, (i+1)*S_loc)`` of q, k and v
([B, S_loc, H, D], GQA-aware); the reference runs these inside
``shard_map`` with the axis bound, the port on each rank with the axis's
process group (``parallel/comm.py``) of ``mesh`` (default: the default
mesh).

* :func:`ring_attention` — the KV blocks rotate around the ring
  (:func:`comm.permute`, whose backward rotates the cotangents back).
  Each hop runs the flash kernels (``ops/flash_attention.
  flash_attention_lse``: out and lse) and the hops merge by log-sum-exp;
  both outputs differentiate, the lse cotangent folding into the backward
  kernels' delta.  Under causality the first hop is the diagonal block
  (causal kernel); a hop whose KV shard comes after this rank's is
  killed by setting its lse to -inf (weight 0 in the merge, no NaN and
  no gradient), its kernels still run, in lockstep, as in the reference.
  Where the lse kernel does not take the shapes (a KV shard of another
  length than Q's; D > 128 on the card) the call raises on CUDA tensors;
  on CPU tensors the reference's dense blockwise online-softmax hop runs
  instead, counted by ``ops.flash_attention.fallback_count()``.
* :func:`ulysses_attention` — all-to-all from sequence-sharded to
  head-sharded (heads must divide by the axis size), flash attention
  over the full sequence, all-to-all back.
"""

from __future__ import annotations

import math

import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.mesh import default_mesh

__all__ = ["ring_attention", "make_ring_attention_fn", "ulysses_attention",
           "merge_hops"]

#: The reference's mask value on the dense hop (finfo(fp32).min).
_NEG = torch.finfo(torch.float32).min


def _axis(axis_name, mesh):
    return comm.axis_group(mesh if mesh is not None else default_mesh(),
                           axis_name)


def merge_hops(out_a, lse_a, out_b, lse_b):
    """Attention over two disjoint key sets merged by log-sum-exp: outs
    [B, S, H, D] (fp32), lses [B, H, S]; returns (out, lse).  ``lse_a``
    must be finite; a ``-inf`` ``lse_b`` (a killed hop) leaves ``out_a``
    and gives ``out_b`` and ``lse_b`` zero cotangents, no NaN."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse).transpose(1, 2)[..., None]
    return out_a * w_a + out_b * w_b, lse


def _ring_flash(q, k, v, axis, causal):
    n, my = axis.size, axis.index
    out_acc = lse_acc = None
    k_blk, v_blk = k, v
    for t in range(n):
        o_t, lse_t = fa.flash_attention_lse(q, k_blk, v_blk,
                                            causal=causal and t == 0)
        o_t = o_t.float()
        if causal and t > 0 and (my - t) % n > my:
            lse_t = torch.full_like(lse_t, float("-inf"))
        if t == 0:
            # The diagonal hop is never killed: the accumulators start
            # finite, so no merge below sees -inf - (-inf).
            out_acc, lse_acc = o_t, lse_t
        else:
            out_acc, lse_acc = merge_hops(out_acc, lse_acc, o_t, lse_t)
        if t < n - 1:
            k_blk = comm.permute(k_blk, axis)
            v_blk = comm.permute(v_blk, axis)
    return out_acc.to(q.dtype)


def _ring_dense(q, k, v, axis, causal):
    """The reference's online-softmax hop (fp32 accumulators, scores in
    the inputs' dtype cast to fp32, masked with finfo(fp32).min)."""
    n, my = axis.size, axis.index
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    o = torch.zeros((B, Hkv, Hq // Hkv, Sq, D), dtype=torch.float32,
                    device=q.device)
    m = torch.full(o.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n):
        src = (my - t) % n
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk).float()
        s = s / math.sqrt(D)
        if causal:
            mask = (my * Sq + q_pos)[:, None] >= (src * Sk + k_pos)[None, :]
            s = torch.where(mask, s, _NEG)
        new_m = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype),
                          v_blk).float()
        o = o * alpha[..., None] + pv
        m = new_m
        if t < n - 1:
            k_blk = comm.permute(k_blk, axis)
            v_blk = comm.permute(v_blk, axis)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def ring_attention(q, k, v, *, axis_name: str = "seq", causal: bool = True,
                   mesh=None):
    """Blockwise attention with KV rotating around the ``axis_name`` ring;
    per shard q [B, S_loc, H, D], k/v [B, S_loc, Hkv, D]; returns
    [B, S_loc, H, D] in q's dtype.  Shapes off the lse kernels (a KV shard
    of another length than Q's; D > 128) raise on CUDA tensors, as
    :func:`flash_attention` does, and run the counted dense hop on CPU
    tensors."""
    lse_ok = fa.flash_lse_supported(q.shape[1], q.shape[3], q.device)
    if lse_ok and k.shape[1] == q.shape[1]:
        return _ring_flash(q, k, v, _axis(axis_name, mesh), causal)
    reason = (f"shard length {q.shape[1]} / head dim {q.shape[3]} is off "
              f"the lse kernels" if not lse_ok else
              f"KV shard length {k.shape[1]} != Q shard length {q.shape[1]}")
    if q.device.type == "cuda":
        raise ValueError(f"ring_attention: {reason}; the flash ring has no "
                         "CUDA kernel for it")
    fa._note_fallback("ring attention hop uses the dense online-softmax "
                      "path: " + reason)
    return _ring_dense(q, k, v, _axis(axis_name, mesh), causal)


def make_ring_attention_fn(axis_name: str = "seq", mesh=None):
    """Adapter for the model's ``attention_fn(q, k, v)`` seam (causal)."""

    def attention_fn(q, k, v, *args, **kwargs):
        return ring_attention(q, k, v, axis_name=axis_name, causal=True,
                              mesh=mesh)

    return attention_fn


def ulysses_attention(q, k, v, *, axis_name: str = "seq",
                      causal: bool = True, mesh=None):
    """DeepSpeed-Ulysses: all-to-all from sequence-sharded to
    head-sharded, flash attention over the full sequence, all-to-all
    back.  Per-shard shapes as in :func:`ring_attention`; H and Hkv must
    divide by the axis size."""
    axis = _axis(axis_name, mesh)
    n = axis.size
    if q.shape[2] % n != 0 or k.shape[2] % n != 0:
        raise ValueError(
            f"ulysses requires heads ({q.shape[2]}, kv {k.shape[2]}) "
            f"divisible by the {axis_name!r} axis size {n}")
    qh, kh, vh = (comm.all_to_all(t, axis, 2, 1) for t in (q, k, v))
    out = fa.flash_attention(qh, kh, vh, causal=causal)
    return comm.all_to_all(out, axis, 1, 2)

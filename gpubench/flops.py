"""The yardstick's arithmetic: the chip's peaks, model FLOPs a step and
the flash kernels' bounds.

Each function is a frozen copy of the program-side arithmetic it names,
taken so that a later change to the program cannot move the yardstick.
The benchmark imports nothing of ``chip_smoke.py`` or ``bench.py``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense rates without sparsity (the card's
#: power limit is recorded beside each run).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: Kernel groups of a training step's device trace, by a substring of the
#: kernel's name (first match wins).  Frozen copy of ``KERNEL_GROUPS``,
#: ``chip_smoke.py:2465``.
KERNEL_GROUPS = (("flash", ("fwd_bf16", "bwd_dq_bf16", "bwd_dkv_bf16")),
                 ("rms_norm", ("rms_fwd_kernel", "rms_bwd_kernel",
                               "rms_bwd_ring")),
                 ("layer_norm", ("layer_norm",)),
                 ("conv", ("fprop", "dgrad", "wgrad", "conv")),
                 ("gemm", ("nvjet", "gemm", "cutlass", "sm90_")),
                 ("optimizer", ("multi_tensor_apply",)),
                 ("nccl", ("nccl",)),
                 ("reduce", ("reduce_kernel",)),
                 ("elementwise", ("elementwise", "copy", "fill")))


def kernel_group(name: str) -> str:
    """Frozen copy of ``kernel_group``, ``chip_smoke.py:2477``."""
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in name for k in keys)), "other")


def attn_pairs(B: int, S: int, heads: int, causal: bool,
               valid_keys: int = None) -> int:
    """(query, key) pairs the attention computes, from
    ``attn_pairs``, ``chip_smoke.py:964``: with a key-padding mask every
    query of a row against its valid keys (``valid_keys`` = the mask's
    sum over the batch), else S² (or the causal triangle) a row."""
    if valid_keys is not None:
        return heads * S * int(valid_keys)
    return B * heads * (S * (S + 1) // 2 if causal else S * S)


#: The three kernels of one attention call, forward and backward.
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_bound_s(name: str, B: int, S: int, Hq: int, Hkv: int, D: int,
                  valid_keys: int = None, causal: bool = False) -> float:
    """The least time of one bf16 flash kernel call, in seconds: the
    larger of its bytes (each input read once, each output written once)
    over HBM bandwidth and the tensor-core FLOPs of the live pairs (2·D a
    pair and product: 2 products forward; dQ 3, the scores recomputed;
    dK/dV 4) over the bf16 peak.  Frozen copy of ``flash_bound``,
    ``chip_smoke.py:978`` (the key-bias sideband adds 4 bytes a key)."""
    pairs = attn_pairs(B, S, Hq, causal, valid_keys)
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[name]
    q_bytes, kv_bytes, row_bytes = (B * S * Hq * D * 2, B * S * Hkv * D * 2,
                                    B * Hq * S * 4)
    nbytes = {"flash_fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
              "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
              "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
              }[name] + (0 if valid_keys is None else 4 * B * S)
    return max(nbytes / HBM_BYTES_PER_S,
               2 * D * products * pairs / PEAK_BF16_FLOPS)


def bert_flops(cfg: dict, B: int, S: int, valid_keys: int) -> int:
    """Model FLOPs of one BERT pretraining step on B rows of S tokens:
    6 x (the encoder layers' parameters + the tied head's V·H +
    ``mlm_transform``) x B·S + 3 x the attention forward (two products of
    2·D FLOPs a (query, valid key) pair, head and layer).  Frozen copy of
    ``bert_flops``, ``chip_smoke.py:2600``; ``cfg`` holds
    google-research/bert's ``bert_config.json`` keys."""
    H, F_ = cfg["hidden_size"], cfg["intermediate_size"]
    L, heads = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    per_layer = 4 * H * H + 2 * H * F_ + 9 * H + F_   # weights, biases, LNs
    dense = L * per_layer + cfg["vocab_size"] * H + H * H + H
    pairs = attn_pairs(B, S, heads, False, valid_keys)
    return 6 * dense * B * S + 3 * L * 4 * (H // heads) * pairs


def resnet_blocks(stage_sizes: Sequence[int], width: int
                  ) -> Iterable[Tuple[int, int, int]]:
    """(in channels, filters, stride) of every bottleneck block, in order:
    stride 2 on the first block of every stage but the first (v1.5)."""
    cin = width
    for stage, n in enumerate(stage_sizes):
        filters = width * 2 ** stage
        for b in range(n):
            yield cin, filters, 2 if stage > 0 and b == 0 else 1
            cin = filters * 4


def bottleneck_convs(cin: int, filters: int, stride: int):
    """(in, out, kernel, stride) of a bottleneck's convolutions: 1x1
    reduce, 3x3 (carries the stride), 1x1 expand x4, then a 1x1
    projection of the residual where the shapes change."""
    out = filters * 4
    convs = [(cin, filters, 1, 1), (filters, filters, 3, stride),
             (filters, out, 1, 1)]
    if cin != out or stride != 1:
        convs.append((cin, out, 1, stride))
    return convs


def resnet_flops(cfg: dict, image_size: int, batch: int) -> int:
    """Model FLOPs of one ResNet training step: 2 per multiply-add of
    every convolution and of the head (ReLU, BatchNorm, pooling and the
    update are not counted), forward + backward = 3 x forward.  Frozen
    copy of ``model_flops_per_step``, ``horovod_tpu_torch/bench.py:170``,
    for bottleneck blocks."""
    def out(size, stride):          # "SAME" and the stem's padding 3
        return -(-size // stride)

    width = cfg["width"]
    size = out(image_size, 2)
    fwd = batch * size * size * 7 * 7 * 3 * width
    size = out(size, 2)             # max pool
    for cin, filters, stride in resnet_blocks(cfg["stage_sizes"], width):
        convs = bottleneck_convs(cin, filters, stride)
        s = size
        for ci, co, k, st in convs[:3]:
            s = out(s, st)
            fwd += batch * s * s * k * k * ci * co
        for ci, co, k, st in convs[3:]:
            fwd += batch * out(size, st) ** 2 * k * k * ci * co
        size = s
    features = width * 2 ** (len(cfg["stage_sizes"]) - 1) * 4
    fwd += batch * features * cfg["num_classes"]
    return 3 * 2 * fwd

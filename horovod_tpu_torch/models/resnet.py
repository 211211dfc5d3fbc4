"""ResNet v1.5 family (18/34/50/101) (PyTorch).

Counterpart of ``horovod_tpu/models/resnet.py``, the model ``bench.py``
times; the parity tests hold its logits, running statistics and gradients
against the flax model on the same weights (``models/convert.py``).  The
math is the reference's:

* **Layout.** The public input is NHWC, ``x [B, H, W, 3]``, as the
  reference's.  Inside, activations are NCHW tensors in
  ``torch.channels_last`` memory — the same bytes as NHWC, so entering is
  a free ``permute`` — which cuDNN convolves without a layout change.
* **Parameters are fp32 and computation runs in ``cfg.dtype``** (bf16 by
  default), as flax's ``param_dtype`` (fp32) and ``dtype=`` give it: every
  convolution casts its kernel and input to ``dtype`` at each use, so the
  gradients are fp32 and an optimizer steps the parameters directly.
* **Convolutions** are ``F.conv2d`` (cuDNN on the card), as the reference
  leaves its convolutions to XLA.  Padding ``"SAME"`` is flax's:
  :func:`same_padding` puts ``total // 2`` before and the rest after, so
  a stride-2 3x3 convolution or 3x3 max pool on an even input pads (0, 1),
  not ``nn.Conv2d(padding=1)``'s (1, 1).  Those take an explicit ``F.pad``
  (zeros for a convolution, −inf for the pool) and no padding of their
  own; symmetric cases pass their padding to the call.
* **BatchNorm** is flax's ``nn.BatchNorm``, not ``nn.BatchNorm2d``: the
  statistics in fp32 with the fast variance ``max(0, E[x²] − E[x]²)``, the
  normalisation in fp32 (``(x − mean) · rsqrt(var + 1e-5) · scale +
  bias``, then cast to ``dtype``), and in train mode the running
  statistics ``r = 0.99 · r + 0.01 · batch`` with the *biased* batch
  variance; eval mode (``train=False``) normalises with them.  Statistics
  are per process, as in the reference's ``shard_map`` step (not SyncBN);
  ``make_train_step`` averages the running
  statistics across ranks after each step, as the reference averages its
  ``batch_stats``.  The last BatchNorm scale of each block starts at zero
  (``convert.init_params``).  Placed for the reference's GSPMD step
  (below), they are the global batch's.
* **Tail.** The global average pool takes an fp32 mean over H and W and
  returns ``dtype`` (``jnp.mean`` of bf16); the head is an fp32 ``Dense``.

**Placed** on a mesh (``parallel/api.py`` ``shard_params``, for
``make_parallel_train_step``), the modules' ``placement``
(``parallel/placement.py``; None on one rank) names the collectives'
axes (``parallel/comm.py``).  Every convolution is split on its
out-channels over ``tensor``, so the activations between the stem and the
pool are split on channels: each convolution reads its input gathered
whole over ``tensor`` (on the NHWC view, which ``channels_last`` makes
contiguous; the backward reduce-scatters), while BatchNorm (with this
rank's part of its scale and bias), ReLU, the max pool, the residual add
(both sides split alike) and the average pool run on the slice; the
pooled [B, C/t] is gathered (far fewer bytes than [B, C, 7, 7]); the head
is column-parallel over the classes, its logits gathered.  In train mode
BatchNorm sums each channel's Σx and Σx² (fp32) and the count over the
data-like axes (``comm.psum``: every rank's loss reads every rank's rows
through them, so the backward sums too) before it forms the mean and
variance, as the reference's one program normalises over the global
batch; the running statistics are updated from those and gathered over
``tensor``, whole and equal on every rank.  Unplaced, or with every
data-like axis of size 1, the statistics are computed as above, op for
op.

``ResNet50()`` and its siblings build a seeded model (flax's
initializers' distributions, not its bits) on the CUDA device, or on the
CPU when asked; ``ResNet.from_state_dict`` wraps converted weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.parallel import comm
from horovod_tpu_torch.parallel.placement import UNPLACED

__all__ = ["ResNetConfig", "ResNet", "BasicBlock", "BottleneckBlock",
           "BatchNorm", "Conv", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "same_padding", "block_convs", "BN_EPS",
           "BN_MOMENTUM"]

#: flax ``nn.BatchNorm``'s defaults.
BN_EPS = 1e-5
BN_MOMENTUM = 0.99


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    block: str = "bottleneck"           # or "basic"
    num_classes: int = 1000
    width: int = 64
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got "
                             f"{self.block!r}")

    @staticmethod
    def resnet18(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(2, 2, 2, 2), block="basic", **kw)

    @staticmethod
    def resnet34(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), block="basic", **kw)

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3), block="bottleneck", **kw)

    @staticmethod
    def resnet101(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 23, 3), block="bottleneck",
                            **kw)

    @property
    def block_name(self) -> str:
        """The flax class name, which names the blocks' parameter trees
        (``BottleneckBlock_0``, ...)."""
        return "BottleneckBlock" if self.block == "bottleneck" else \
            "BasicBlock"

    @property
    def features(self) -> int:
        """Channels into the head."""
        return self.width * 2 ** (len(self.stage_sizes) - 1) * \
            (4 if self.block == "bottleneck" else 1)

    def blocks(self) -> Iterator[Tuple[int, int, int, int]]:
        """(index, in channels, filters, stride) of every block, in order:
        stride 2 on the first block of every stage but the first."""
        cin, i = self.width, 0
        expand = 4 if self.block == "bottleneck" else 1
        for stage, n in enumerate(self.stage_sizes):
            filters = self.width * 2 ** stage
            for b in range(n):
                yield i, cin, filters, 2 if stage > 0 and b == 0 else 1
                cin, i = filters * expand, i + 1


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one dim: (low, high) with total
    ``max((ceil(size / stride) − 1) · stride + kernel − size, 0)`` and
    ``low = total // 2``."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def block_convs(block: str, cin: int, filters: int, stride: int
                ) -> List[Tuple[int, int, int, int]]:
    """(in, out, kernel, stride) of a block's convolutions in flax's
    creation order (``Conv_0``, ``Conv_1``, ...): the main path (v1.5: a
    bottleneck's stride on its 3x3), then a 1x1 projection of the residual
    where the shapes change.  ``BatchNorm_j`` follows ``Conv_j``; the
    main path's last one starts with a zero scale."""
    if block == "bottleneck":
        out = filters * 4
        convs = [(cin, filters, 1, 1), (filters, filters, 3, stride),
                 (filters, out, 1, 1)]
    else:
        out = filters
        convs = [(cin, filters, 3, stride), (filters, filters, 3, 1)]
    if cin != out or stride != 1:
        convs.append((cin, out, 1, stride))
    return convs


def gather_channels(x: torch.Tensor, axis) -> torch.Tensor:
    """An NCHW activation split on channels over ``axis`` (a ``comm``
    axis, or None for ``x`` itself), whole, for convolutions split over
    it: gathered on the NHWC view (contiguous under ``channels_last``),
    the backward summing the ranks' cotangents and keeping this rank's
    channels."""
    if axis is None:
        return x
    return comm.gather_shards(x.permute(0, 2, 3, 1), axis,
                              3).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding, use_bias=False,
    dtype=compute_dtype)``: an fp32 weight ``[out, in, k, k]`` (flax's
    kernel is ``[k, k, in, out]``) cast with the input to
    ``compute_dtype`` at every use.  ``padding``: ``"SAME"`` or a
    symmetric int.  Placed, the weight holds this rank's out-channels and
    the input is whole."""

    placement = None

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 compute_dtype: torch.dtype, padding="SAME", device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, kernel, kernel), dtype=torch.float32, device=device))
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pl = self.placement or UNPLACED
        dt = self.compute_dtype
        w = pl.weight(self.weight).to(dt, memory_format=torch.channels_last)
        x = x.to(dt)
        pad = self.padding
        if pad == "SAME":
            ph = same_padding(x.shape[2], self.kernel, self.stride)
            pw = same_padding(x.shape[3], self.kernel, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (*pw, *ph))
                pad = 0
        return F.conv2d(x, w, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=compute_dtype)`` over N, H, W of an NCHW
    input: fp32 ``scale`` and ``bias`` parameters, fp32 running ``mean``
    and ``var`` buffers (flax's ``batch_stats``), updated in place in train
    mode.  ``chan``: the ``comm`` axis the input's channels are split
    over, or None; placed with data-like axes larger than 1, the train
    statistics are the global batch's."""

    placement = None

    def __init__(self, features: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(features, **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, train: bool,
                chan=None) -> torch.Tensor:
        pl = self.placement or UNPLACED
        if train:
            x32 = x.float()
            if pl.batch:
                mean, var = _global_stats(x32, pl.batch)
            else:
                mean = x32.mean(dim=(0, 2, 3))
                var = torch.clamp_min((x32 * x32).mean(dim=(0, 2, 3))
                                      - mean * mean, 0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                new_mean, new_var = (comm.gather(s.detach(), chan, 0)
                                     for s in (mean, var))
                self.mean.copy_(m * self.mean + (1 - m) * new_mean)
                self.var.copy_(m * self.var + (1 - m) * new_var)
        else:
            mean, var = (comm.split(s, chan, 0) for s in (self.mean,
                                                          self.var))
        mul = torch.rsqrt(var + BN_EPS) * comm.split(self.scale, chan, 0)
        c = (1, -1, 1, 1)
        y = (x - mean.view(c)) * mul.view(c) \
            + comm.split(self.bias, chan, 0).view(c)
        return y.to(self.compute_dtype)


def _global_stats(x32: torch.Tensor, axes):
    """Each channel's mean and (fast, biased) variance over N, H, W of
    every rank's rows: Σx, Σx² and the count summed over ``axes``."""
    C = x32.shape[1]
    sums = torch.cat([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3)),
                      x32.new_full((1,), x32.numel() // C)])
    sums = comm.psum(sums, axes)
    mean = sums[:C] / sums[-1]
    return mean, torch.clamp_min(sums[C:2 * C] / sums[-1] - mean * mean, 0.0)


class _Block(nn.Module):
    """Shared by both blocks: ``convs[j]`` and ``norms[j]`` are flax's
    ``Conv_j`` and ``BatchNorm_j``; a projection of the residual, when
    the shapes change, is the last pair.  ``chan``: the ``comm`` axis the
    input's and output's channels are split over, or None."""

    block = ""

    def __init__(self, cin: int, filters: int, stride: int,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        shapes = block_convs(self.block, cin, filters, stride)
        self.convs = nn.ModuleList(
            Conv(i, o, k, s, compute_dtype, device=device)
            for i, o, k, s in shapes)
        self.norms = nn.ModuleList(BatchNorm(o, compute_dtype, device)
                                   for _, o, _, _ in shapes)
        self.n_main = 3 if self.block == "bottleneck" else 2

    def forward(self, x: torch.Tensor, train: bool,
                chan=None) -> torch.Tensor:
        whole = gather_channels(x, chan)
        y = whole
        for j in range(self.n_main):
            y = self.norms[j](self.convs[j](y), train, chan)
            if j < self.n_main - 1:
                y = gather_channels(F.relu(y), chan)
        residual = x
        if len(self.convs) > self.n_main:
            residual = self.norms[-1](self.convs[-1](whole), train, chan)
        return F.relu(residual + y)


class BasicBlock(_Block):
    """3x3 → 3x3, the first carrying the stride."""

    block = "basic"


class BottleneckBlock(_Block):
    """1x1 reduce → 3x3 (carries the stride: v1.5) → 1x1 expand ×4."""

    block = "bottleneck"


class ResNet(nn.Module):
    """``forward(x [B, H, W, 3], train=False) -> fp32 logits [B,
    num_classes]``; ``train=True`` normalises with the batch's statistics
    and updates the running ones."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.config = cfg
        dt, w = cfg.dtype, cfg.width
        self.conv_init = Conv(3, w, 7, 2, dt, padding=3, device=device)
        self.bn_init = BatchNorm(w, dt, device)
        block_cls = BottleneckBlock if cfg.block == "bottleneck" else \
            BasicBlock
        self.blocks = nn.ModuleList(
            block_cls(cin, filters, stride, dt, device)
            for _, cin, filters, stride in cfg.blocks())
        self.head = nn.Linear(cfg.features, cfg.num_classes,
                              dtype=torch.float32, device=device)

    @classmethod
    def from_state_dict(cls, cfg: ResNetConfig,
                        state: Dict[str, torch.Tensor]) -> "ResNet":
        """Wrap ready tensors (``convert.init_params`` /
        ``convert.params_from_jax``: parameters and running statistics)
        without allocating a second copy."""
        model = cls(cfg, device="meta")
        model.load_state_dict(state, strict=True, assign=True)
        return model

    placement = None

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        pl = self.placement or UNPLACED
        dt = self.config.dtype
        chan = pl.tensor_at(self.conv_init.weight, 0)
        x = x.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x), train, chan))
        ph = same_padding(x.shape[2], 3, 2)
        pw = same_padding(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (*pw, *ph), value=-math.inf), 3, 2)
        for block in self.blocks:
            x = block(x, train, chan)
        x = x.float().mean(dim=(2, 3)).to(dt)
        classes = pl.tensor_at(self.head.weight, 0)
        x = comm.copy_to(comm.gather(x, chan, 1), classes)
        logits = F.linear(x.float(), pl.weight(self.head.weight),
                          comm.split(self.head.bias, classes, 0))
        return comm.gather(logits, classes, -1)


def _build(cfg: ResNetConfig, seed: int, device) -> ResNet:
    from horovod_tpu_torch.models.convert import init_params

    return ResNet.from_state_dict(cfg, init_params(cfg, seed, device))


def ResNet18(*, seed: int = 0, device=None, **kw) -> ResNet:
    """Seeded ResNet-18 on ``device`` (``None``: the CUDA device);
    ``kw``: ``ResNetConfig`` fields (num_classes, width, dtype)."""
    return _build(ResNetConfig.resnet18(**kw), seed, device)


def ResNet34(*, seed: int = 0, device=None, **kw) -> ResNet:
    """Seeded ResNet-34 (as :func:`ResNet18`)."""
    return _build(ResNetConfig.resnet34(**kw), seed, device)


def ResNet50(*, seed: int = 0, device=None, **kw) -> ResNet:
    """Seeded ResNet-50 (as :func:`ResNet18`)."""
    return _build(ResNetConfig.resnet50(**kw), seed, device)


def ResNet101(*, seed: int = 0, device=None, **kw) -> ResNet:
    """Seeded ResNet-101 (as :func:`ResNet18`)."""
    return _build(ResNetConfig.resnet101(**kw), seed, device)

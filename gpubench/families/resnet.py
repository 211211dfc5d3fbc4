"""ResNet-50 training on the port: ``models/resnet.py`` (cuDNN
convolutions in bf16 on fp32 parameters, the eager fp32 BatchNorm on
batch statistics), the loss of ``bench.py``: the mean NLL of an fp32
log-softmax.  The batches are synthetic ImageNet: standard-normal
[B, H, W, 3] fp32 images and labels uniform over the classes, drawn on
the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpubench import flops
from gpubench.weights import derive


def rows(traffic: dict) -> int:
    return traffic["rows_per_rank"]


def block(cfg: dict, traffic: dict, seed: int, index: int, rank: int,
          device) -> dict:
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, "images", index, rank))
    B, size = traffic["rows_per_rank"], traffic["image_size"]
    images = torch.randn((B, size, size, 3), generator=gen, device=device)
    labels = torch.randint(0, cfg["num_classes"], (B,), generator=gen,
                           device=device)
    return {"images": images, "labels": labels}


def build(cfg: dict, state: dict):
    from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig

    rcfg = ResNetConfig(stage_sizes=tuple(cfg["stage_sizes"]),
                        block="bottleneck", num_classes=cfg["num_classes"],
                        width=cfg["width"],
                        dtype=getattr(torch, cfg["training"]["compute_dtype"]))
    model = ResNet.from_state_dict(rcfg, state)

    def loss_fn(model, batch):
        with torch.profiler.record_function("gpubench.loss"):
            logp = F.log_softmax(model(batch["images"], train=True).float(),
                                 dim=-1)
            return -logp.gather(1, batch["labels"][:, None]).mean()

    return model, loss_fn


def step_flops(cfg: dict, traffic: dict, index: int, world: int) -> int:
    return flops.resnet_flops(cfg, traffic["image_size"],
                              traffic["rows_per_rank"] * world)


def attention_bound_s(cfg: dict, batch: dict):
    return None

"""Shared helpers of the benchmark's tests: tiny cells on the CPU, and
the ``cuda`` marker for tests that need the card (skipped elsewhere, the
decision made inside the ``cuda_device`` fixture)."""

from __future__ import annotations

import copy

import pytest

from gpubench import manifest

TINY_BERT = {"num_hidden_layers": 2, "hidden_size": 64,
             "num_attention_heads": 4, "intermediate_size": 128,
             "vocab_size": 1024, "max_position_embeddings": 64}
TINY_BERT_TRAFFIC = {"rows_per_rank": 4, "seq_len": 64, "pool": 4,
                     "warmup_steps": 1, "max_predictions_per_seq": 10}
TINY_RESNET = {"stage_sizes": [1, 1, 1, 1], "width": 16, "num_classes": 16}
TINY_RESNET_TRAFFIC = {"rows_per_rank": 16, "image_size": 64, "pool": 4,
                       "warmup_steps": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)


def tiny_cell(workload: str, limits=None) -> manifest.Cell:
    """The workload of ``BENCHMARK.json`` cut to a CPU test's size (its
    configuration's widths and depth, and its traffic's rows)."""
    cell = manifest.cell(manifest.load(), workload)
    cell = copy.deepcopy(cell)
    if cell.config["family"] == "bert":
        cell.config.update(TINY_BERT)
        cell.traffic.update(TINY_BERT_TRAFFIC)
    else:
        cell.config.update(TINY_RESNET)
        cell.traffic.update(TINY_RESNET_TRAFFIC)
    if limits is not None:
        cell.limits = dict(limits)
    return cell

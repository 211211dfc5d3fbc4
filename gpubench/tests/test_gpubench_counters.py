"""The FLOP and bound counters against hand counts."""

import pytest

from gpubench import flops

BERT_BASE = {"hidden_size": 768, "intermediate_size": 3072,
             "num_hidden_layers": 12, "num_attention_heads": 12,
             "vocab_size": 30522}
RESNET50 = {"width": 64, "stage_sizes": [3, 4, 6, 3], "num_classes": 1000}


def test_bert_flops_by_hand():
    # One layer, H 2, F 4, 1 head, V 3, B 1, S 2, both keys valid:
    # per layer 4·4 + 2·2·4 + 9·2 + 4 = 54; dense 54 + 3·2 + 4 + 2 = 66;
    # 6·66·2 tokens + 3 layers·4·D(2)·pairs(1·2·2) = 792 + 48.
    cfg = {"hidden_size": 2, "intermediate_size": 4, "num_hidden_layers": 1,
           "num_attention_heads": 1, "vocab_size": 3}
    assert flops.bert_flops(cfg, 1, 2, 2) == 792 + 3 * 4 * 2 * 4


def test_bert_base_step_matches_the_bring_up():
    # chip_smoke.py's train_bert batch: 213 of 16384 keys masked, 11.64 TFLOP.
    assert flops.bert_flops(BERT_BASE, 32, 512, 16384 - 213) == \
        pytest.approx(11.639e12, rel=1e-4)


def test_resnet_flops_by_hand():
    # A 1x1x1x1 stage net of width 1 on a 4x4 image, 2 classes: stem
    # 2x2 outputs x 49 x 3 MACs; pool to 1x1; one block 1->1->1->4 plus
    # a projection 1->4 at 1x1; head 4 -> 2.
    cfg = {"width": 1, "stage_sizes": [1], "num_classes": 2}
    fwd = 4 * 49 * 3 + (1 + 9 + 4) + 4 + 4 * 2
    assert flops.resnet_flops(cfg, 4, 1) == 6 * fwd


def test_resnet50_step_matches_bench():
    # bench.py's headline: 6.28 TFLOP a step of 256 x 224².
    assert flops.resnet_flops(RESNET50, 224, 256) == \
        pytest.approx(6.281e12, rel=1e-3)


@pytest.mark.parametrize("kernel,ms", [("flash_fwd", 0.0303),
                                       ("flash_bwd_dq", 0.0386),
                                       ("flash_bwd_dkv", 0.0514)])
def test_flash_bounds_match_the_kernel_table(kernel, ms):
    # PERF.md's table: key bias, bf16 B 32, S 512, 12 heads of 64.
    got = flops.flash_bound_s(kernel, 32, 512, 12, 12, 64, 16384 - 213)
    assert got * 1e3 == pytest.approx(ms, abs=5e-5)


def test_flash_bound_by_hand():
    # B 1, S 2, 1 head, D 2, no mask: fwd bytes 2·8 + 2·8 + 8 = 40 at
    # 3.35e12; FLOPs 2·2·2·4 pairs = 32 at 989e12; bytes win.
    assert flops.flash_bound_s("flash_fwd", 1, 2, 1, 1, 2) == \
        pytest.approx(40 / flops.HBM_BYTES_PER_S)


def test_kernel_groups():
    assert flops.kernel_group("void fwd_bf16<64, 1>(CUtensorMap)") == "flash"
    assert flops.kernel_group("ncclDevKernel_AllReduce_Sum_f32_RING_LL") \
        == "nccl"
    assert flops.kernel_group("void at::native::multi_tensor_apply_kernel"
                              "<...>") == "optimizer"
    assert flops.kernel_group("void at::native::reduce_kernel<512, 1>") \
        == "reduce"
    assert flops.kernel_group("void at::native::vectorized_elementwise_"
                              "kernel<4>") == "elementwise"
    assert flops.kernel_group("nvjet_tst_128x256") == "gemm"

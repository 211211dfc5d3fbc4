"""Port parity: ``python -m horovod_tpu_torch.bench --model llama``.

The bench's step (``horovod_tpu_torch.bench.make_llama_step``:
``LlamaConfig.tiny()``, flash attention's plain path, the chunked
``softmax_cross_entropy``, ``DistributedOptimizer(MasterWeights(AdamW
3e-4))``, the tokens of ``default_rng(0)``) at B 1 x S 128 against a step
built from the pieces of the reference's ``bench.py`` ``_llama_result``
(``LlamaModel`` with ``flash_attention_fn``, ``softmax_cross_entropy``,
``DistributedOptimizer(master_weights(optax.adamw(3e-4)))``,
``make_train_step``) on the same weights (``params_from_jax``):

* fp32, 3 steps, one rank against a 1-device mesh and two gloo ranks (this
  file run as a script twice, ``_rank_main``; each steps its own rows of
  the global batch, rank 1's weights replaced by the broadcast) against a
  2-device mesh: losses within rtol 1e-5, parameters within 2 x lr (Adam's
  first steps divide each gradient by its own magnitude, so a near-zero
  gradient whose last bits differ between the frameworks moves its
  parameter by up to lr either way);
* bf16, as the bench runs it: the first loss within 1e-2 relative (the
  port keeps the norm scales in fp32, the reference casts them to bf16),
  the loss falling on both sides;
* the CPU smoke prints one JSON line with the smoke metric, and the
  analytic FLOP count gives the bench config's 32.9 TFLOP a step.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import horovod_tpu.jax as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models import LlamaConfig as JaxLlamaConfig
from horovod_tpu.models import LlamaModel as JaxLlamaModel
from horovod_tpu.ops.flash_attention import flash_attention_fn as jax_flash
from horovod_tpu.ops.losses import softmax_cross_entropy as jax_xent
from horovod_tpu.ops.mixed_precision import cast_compute, master_weights
from horovod_tpu_torch import bench
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.models.convert import (init_params, params_from_jax,
                                              params_to_jax)
from horovod_tpu_torch.models.llama import LlamaConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, STEPS = 1, 128, 3
TINY_FP32 = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                                logits_dtype=torch.float32)
JCFG_FP32 = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                                logits_dtype=jnp.float32)


def _variables():
    return JaxLlamaModel(JCFG_FP32).init(jax.random.key(3),
                                         jnp.zeros((1, S), jnp.int32))


def _reference_losses(jcfg, variables, n_dev, bf16=False):
    """bench.py's _llama_result step on an ``n_dev``-device mesh."""
    model = JaxLlamaModel(jcfg, attention_fn=jax_flash)
    tokens = jnp.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B * n_dev, S + 1), dtype=np.int32))
    params = cast_compute(variables) if bf16 else variables
    opt = jhvd.DistributedOptimizer(master_weights(optax.adamw(3e-4)))

    def loss_fn(params, batch_tokens):
        logits = model.apply(params, batch_tokens[:, :-1])
        return jax_xent(logits, batch_tokens[:, 1:])

    mesh = jhvd.data_parallel_mesh(devices=jax.devices()[:n_dev])
    step = jhvd.make_train_step(loss_fn, opt, mesh, donate=False)
    state = opt.init(params)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    return params, np.array(losses)


def _assert_params_close(got_state, jax_params, atol):
    want = params_to_jax(params_from_jax(jax_params, TINY_FP32, "cpu"),
                         TINY_FP32)["params"]
    got = params_to_jax(got_state, TINY_FP32)["params"]
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(flat_g[path], w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _rank_main(src: str, dst: str) -> None:
    """One gloo rank: ``python tests/test_torch_port_bench_llama.py IN.npz
    OUT.npz``.  IN holds rank 0's starting weights (``w.<name>``); rank 1
    starts from other seeded weights.  OUT: the step losses and the final
    weights (``final.<name>``)."""
    hvd.init(device="cpu")
    data = np.load(src)
    state = ({k[2:]: torch.from_numpy(data[k]) for k in data.files}
             if hvd.rank() == 0 else init_params(TINY_FP32, 1001, "cpu"))
    step, model, _, tokens = bench.make_llama_step(TINY_FP32, B, S,
                                                   state=state)
    losses = np.array([float(step(tokens)) for _ in range(STEPS)])
    np.savez(dst, losses=losses, **{"final." + k: v.detach().numpy()
                                    for k, v in model.state_dict().items()})
    hvd.shutdown()


@pytest.fixture
def cpu_world(monkeypatch):
    for name in basics._RANK_ENV + basics._SIZE_ENV + \
            basics._LOCAL_RANK_ENV + basics._LOCAL_SIZE_ENV + \
            ("HOROVOD_COORDINATOR",):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_bench_step_fp32_one_rank_matches_the_reference(cpu_world):
    variables = _variables()
    jparams, jlosses = _reference_losses(JCFG_FP32, variables, 1)
    step, model, _, tokens = bench.make_llama_step(
        TINY_FP32, B, S, state=params_from_jax(variables, TINY_FP32, "cpu"))
    assert tokens.shape == (B, S + 1)
    losses = np.array([float(step(tokens)) for _ in range(STEPS)])
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_params_close(model.state_dict(), jparams, 2 * bench.LLAMA_LR)


def test_bench_step_fp32_two_gloo_ranks_match_the_reference(tmp_path):
    variables = _variables()
    jparams, jlosses = _reference_losses(JCFG_FP32, variables, 2)
    start = params_from_jax(variables, TINY_FP32, "cpu")
    np.savez(tmp_path / "in.npz",
             **{"w." + k: v.numpy() for k, v in start.items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")],
        env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                 HOROVOD_COORDINATOR=f"127.0.0.1:{port}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    finally:
        for p in procs:
            p.kill()
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    for name in start:
        np.testing.assert_array_equal(res[1]["final." + name],
                                      res[0]["final." + name], err_msg=name)
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-5)
    _assert_params_close({k: torch.from_numpy(res[0]["final." + k])
                          for k in start}, jparams, 2 * bench.LLAMA_LR)


def test_bench_step_bf16_tracks_the_reference(cpu_world):
    """The bench's own precision: bf16 weights, fp32 masters."""
    variables = _variables()
    _, jlosses = _reference_losses(JaxLlamaConfig.tiny(), variables, 1,
                                   bf16=True)
    cfg = LlamaConfig.tiny()
    step, model, _, tokens = bench.make_llama_step(
        cfg, B, S, state=params_from_jax(variables, cfg, "cpu"))
    assert model.lm_head.weight.dtype == torch.bfloat16
    losses = np.array([float(step(tokens)) for _ in range(STEPS)])
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]
    assert abs(losses[0] - jlosses[0]) <= 1e-2 * abs(jlosses[0])


def test_llama_smoke_prints_its_json_line():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--model", "llama",
         "--smoke", "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "llama_train_tokens_per_sec_cpu_smoke"
    assert line["value"] > 0 and line["mfu"] is None
    assert line["sustained_tflops"] is None
    assert len(line["step_ms_spread"]) == 3
    assert (line["batch_per_gpu"], line["seq"]) == (1, 128)
    assert all(np.isfinite(line["losses"]))
    assert line["losses"][-1] < line["losses"][0]


def test_flop_count_of_the_bench_config():
    """6 x (non-embedding params + head) x tokens + 3 x the causal
    attention forward: 32.9 TFLOP for B 8 x S 2048."""
    cfg = bench.llama_config()
    assert cfg.head_dim == 128 and not cfg.fused_rmsnorm
    flops = bench.llama_flops_per_step(cfg, 8, 2048)
    assert flops == pytest.approx(32.9e12, rel=2e-3)
    pairs = 8 * cfg.num_heads * 2048 * 2048 // 2
    assert bench.llama_flops_per_step(cfg, 8, 2048, pairs=pairs) == flops


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])

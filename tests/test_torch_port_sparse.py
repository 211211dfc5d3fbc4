"""Port parity: top-k sparse allreduce with error feedback
(``runtime/sparse.py``), ``Compression.topk``, the statistics-driven
wire policy (``runtime/wire_policy.py``) and their call sites.

On one rank, in this process, against ``horovod_tpu.runtime.sparse``:

* selection (indices and their order), residual, output and the
  stale-epoch reset bit for bit on inputs without ties at the k-th
  magnitude; a boundary tie pinned (the reference takes what numpy's
  introselect leaves, the port the documented rule; ROADMAP.md Queue C);
  a bf16 input upcast as the reference's function upcasts it; the
  reference hook form's ``.numpy()`` failure on a bf16 gradient pinned;
* the counterparts of ``tests/test_compression.py:39, :68, :101, :121``;
* the wire policy's statistics within ``|port - ref| <= 1e-6 |ref|``
  (the reference's fp32 pairwise mean of squares against the port's
  fp64 sum rounded to fp32) and its decisions equal, on
  ``tests/wire_policy_worker.py``'s gradients.

Worlds of 2 ranks (this file run as a script per rank, ``_rank_main``),
port and reference each in its own processes:

* ``scenario_wire_sparse`` (``test_compression.py:236``); the 2-rank
  output equal, bit for bit, to the fp64 rank-order sum of the
  reference's per-rank selections, over 3 steps of residuals;
* the hook form (``torch_frontend``) with top-k, top-k without feedback,
  top-k local SGD and the wire policy, bitwise against
  ``horovod_tpu.torch`` on fp32 parameters (fusion off, so both reduce
  tensor by tensor), with the policy's decisions equal;
* the JAX form's top-k and policy routes against ``horovod_tpu.jax``
  within 1e-6 (optax and ``torch.optim.SGD`` round the update apart);
* ``LocalSGD(compression=topk)`` on ``tests/local_sgd_worker.py``'s
  quadratic bitwise against the reference's, with its counters;
* ``tests/compression_worker.py``'s bounds (top-k with feedback converges
  within its pinned envelope, without feedback >= 1.5x worse) and
  ``tests/wire_policy_worker.py``'s (bytes <= 0.60x, matrix -> int8,
  bias -> fp32, fp32-parity loss).

A port process imports no JAX (it checks).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
POLICY_STEPS = 6
LR = 0.05
#: The worlds' wire-policy knob: small enough that the toy leaves are
#: decided by their statistics.
POLICY_MIN_ELEMS = "8"
JF_SHAPES = {"a.w": (3, 4), "a.b": (4,), "b.w": (4, 2)}


@pytest.fixture
def port_one(monkeypatch):
    """The port initialised on a world of one, on the CPU."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.runtime import sparse

    for name in (basics._RANK_ENV + basics._SIZE_ENV + basics._LOCAL_RANK_ENV
                 + basics._LOCAL_SIZE_ENV + ("HOROVOD_COORDINATOR",
                                             "HOROVOD_SPARSE_TOPK",
                                             "HOROVOD_TOPK_SEED",
                                             "HOROVOD_WIRE_POLICY")):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    sparse.reset_residuals()
    yield hvd
    sparse.reset_residuals()
    hvd.shutdown()


def _ref_sparse():
    from horovod_tpu.runtime import sparse

    sparse.reset_residuals()
    return sparse


def _tie_free(rng, n):
    """Distinct magnitudes: no tie at any k."""
    mags = rng.permutation(n).astype(np.float32) + 1.0
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    return (mags * signs * np.float32(1e-3)).astype(np.float32)


# -- one rank, against horovod_tpu.runtime.sparse ---------------------------


@pytest.mark.parametrize("n,ratio,feedback", [
    (1000, 0.01, True), (100, 0.5, True), (37, 1.0, True),
    (5000, 0.013, True), (300, 0.1, False)])
def test_selection_residual_and_output_equal_the_reference(port_one, n,
                                                           ratio, feedback):
    from horovod_tpu_torch.runtime import sparse

    ref = _ref_sparse()
    rng = np.random.default_rng(n)
    k = max(1, min(n, int(round(n * ratio))))
    for step in range(3):
        x = _tie_free(rng, n)
        if step == 2:
            x = x.reshape(-1, 1 if n % 2 else 2)    # any shape, flattened
        want = ref.sparse_allreduce_topk(x, name="t", ratio=ratio,
                                         error_feedback=feedback)
        v = torch.from_numpy(x.reshape(-1).copy())
        entry = sparse._RESIDUALS.get("t")
        if feedback and entry is not None:
            v = v + entry[1]
        got = sparse.sparse_allreduce_topk(torch.from_numpy(x), name="t",
                                           ratio=ratio,
                                           error_feedback=feedback)
        assert got.shape == x.shape and got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), step
        # The reference's own selection rule, applied to the same v.
        vv = v.numpy()
        absv = np.abs(vv)
        if k < n:
            cand = np.argpartition(absv, n - k)[n - k:]
            sel = cand[np.lexsort((ref._tie_perm(n)[cand],
                                   -absv[cand]))[:k]]
        else:
            sel = np.arange(n)
        idx, vals = sparse.select_topk(v, k)
        assert idx.tolist() == sel.tolist()
        assert vals.numpy().tobytes() == vv[sel].tobytes()
        if feedback:
            assert sparse._RESIDUALS["t"][1].numpy().tobytes() == \
                ref._RESIDUALS["t"][1].tobytes()
        else:
            assert "t" not in sparse._RESIDUALS
    ref.reset_residuals()


def test_stale_epoch_residual_starts_from_zero(port_one):
    """A residual of another membership epoch is dropped, in both."""
    from horovod_tpu_torch.runtime import sparse

    ref = _ref_sparse()
    rng = np.random.default_rng(3)
    x = _tie_free(rng, 200)
    stale = rng.standard_normal(200).astype(np.float32)
    ref._RESIDUALS["e"] = (7, stale.copy())
    sparse._RESIDUALS["e"] = (7, torch.from_numpy(stale.copy()))
    want = ref.sparse_allreduce_topk(x, name="e", ratio=0.05)
    got = sparse.sparse_allreduce_topk(torch.from_numpy(x), name="e",
                                       ratio=0.05)
    assert got.numpy().tobytes() == want.tobytes()
    assert sparse._RESIDUALS["e"][0] == ref._RESIDUALS["e"][0] == 0
    assert sparse._RESIDUALS["e"][1].numpy().tobytes() == \
        ref._RESIDUALS["e"][1].tobytes()
    ref.reset_residuals()


def test_boundary_tie_follows_the_documented_rule(port_one):
    """Pinned difference: 64 equal magnitudes, k 6.  The port sends the
    six with the smallest permutation rank; the reference sends the six
    that numpy's introselect leaves past n - k, ordered by the rule."""
    from horovod_tpu_torch.runtime import sparse

    ref = _ref_sparse()
    ones = np.ones(64, np.float32)
    want = ref.sparse_allreduce_topk(ones, name="tie", ratio=0.1,
                                     error_feedback=False)
    got = sparse.sparse_allreduce_topk(torch.from_numpy(ones), name="tie",
                                       ratio=0.1, error_feedback=False)
    perm = np.random.default_rng(0).permutation(64)
    rule = np.sort(np.argsort(perm, kind="stable")[:6])
    assert np.nonzero(got.numpy())[0].tolist() == rule.tolist()
    assert np.nonzero(want)[0].tolist() != rule.tolist()
    assert int((want != 0).sum()) == int((got != 0).sum()) == 6
    # Repeatable, and a different seed picks other entries.
    again = sparse.sparse_allreduce_topk(torch.from_numpy(ones), name="tie",
                                         ratio=0.1, error_feedback=False)
    assert torch.equal(again, got)
    os.environ["HOROVOD_TOPK_SEED"] = "5"
    try:
        other = sparse.sparse_allreduce_topk(torch.from_numpy(ones),
                                             name="tie", ratio=0.1,
                                             error_feedback=False)
    finally:
        del os.environ["HOROVOD_TOPK_SEED"]
    assert not torch.equal(other, got)


def test_bf16_input_is_upcast_as_the_reference_upcasts_it(port_one):
    import ml_dtypes
    from horovod_tpu_torch.runtime import sparse

    ref = _ref_sparse()
    rng = np.random.default_rng(9)
    # 512 distinct magnitudes that bf16 holds exactly: 2^-e (1 + m/128).
    mags = np.array([2.0 ** -e * (1 + m / 128) for e in range(4)
                     for m in range(128)], np.float32)
    x = rng.permutation(mags) * rng.choice(np.array([-1.0, 1.0],
                                                    np.float32), 512)
    xb = x.astype(ml_dtypes.bfloat16)
    assert np.array_equal(xb.astype(np.float32), x)
    want = ref.sparse_allreduce_topk(xb, name="b", ratio=0.01)
    got = sparse.sparse_allreduce_topk(
        torch.from_numpy(x).to(torch.bfloat16), name="b", ratio=0.01)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert sparse._RESIDUALS["b"][1].numpy().tobytes() == \
        ref._RESIDUALS["b"][1].tobytes()
    ref.reset_residuals()


def test_reference_hook_form_fails_on_a_bf16_gradient(port_one):
    """Pinned difference: the reference's hook form hands
    ``p.grad.cpu().numpy()`` to the sparse path, which numpy refuses for
    bf16; the port reduces the bf16 gradient in fp32 and writes it back in
    bf16."""
    import horovod_tpu.torch as ref_hvd
    from horovod_tpu.torch.compression import Compression as RefCompression
    from horovod_tpu_torch import torch_frontend
    from horovod_tpu_torch.ops.compression import Compression

    def step(mod, comp):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 40).to(torch.bfloat16))
        opt = mod.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                       named_parameters=[("w", p)],
                                       compression=comp.topk(0.1))
        (p.float() ** 3).sum().backward()
        opt.synchronize()
        return p.grad

    with pytest.raises(TypeError):
        step(ref_hvd, RefCompression)
    _ref_sparse()
    g = step(torch_frontend, Compression)
    assert g.dtype == torch.bfloat16 and int((g != 0).sum()) == 4


def test_compression_registry_wire_and_topk(port_one):
    """``test_compression.py:39``."""
    from horovod_tpu.ops.compression import Compression as RefCompression
    from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
    from horovod_tpu_torch.runtime.sparse import default_topk_ratio

    for name, wd in (("wire_fp16", "fp16"), ("wire_bf16", "bf16"),
                     ("wire_int8", "int8"), ("wire_fp8", "fp8")):
        comp = getattr(Compression, name)
        assert comp.engine_wire_dtype == wd
        t = torch.ones(4)
        out, ctx = comp.compress(t)
        assert out is t and ctx is None
        assert comp.decompress(out, ctx) is t
    spec = Compression.topk(0.05, error_feedback=False)
    assert isinstance(spec, TopKCompressor)
    assert spec.ratio == 0.05 and spec.error_feedback is False
    t = torch.ones(3)
    assert spec.compress(t) == (t, None) and spec.decompress(t, None) is t
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError) as got:
            Compression.topk(bad)
        with pytest.raises(ValueError) as want:
            RefCompression.topk(bad)
        assert str(got.value) == str(want.value)
    assert Compression.topk().ratio is None
    assert default_topk_ratio() == 0.01
    for raw, want in (("0.05", 0.05), ("junk", 0.01), ("7", 1.0),
                      ("0", 1e-6)):
        os.environ["HOROVOD_SPARSE_TOPK"] = raw
        try:
            assert default_topk_ratio() == want
        finally:
            del os.environ["HOROVOD_SPARSE_TOPK"]


def test_topk_selection_deterministic_and_residuals_local(port_one):
    """``test_compression.py:68``."""
    from horovod_tpu_torch.runtime import sparse

    x = torch.zeros(100)
    x[3], x[10], x[50] = 5.0, -7.0, 1.0
    out = sparse.sparse_allreduce_topk(x, name="u.t", ratio=0.02)
    assert out[10] == -7.0 and out[3] == 5.0 and out[50] == 0.0
    assert sparse.residual_norm("u.t") == pytest.approx(1.0)
    out2 = sparse.sparse_allreduce_topk(torch.zeros(100), name="u.t",
                                        ratio=0.02)
    assert out2[50] == 1.0
    assert sparse.residual_norm("u.t") == 0.0
    sparse.reset_residuals("u.t")
    assert sparse.residual_norm("u.t") == 0.0
    ones = torch.ones(64)
    a = sparse.sparse_allreduce_topk(ones, name="u.tie", ratio=0.1,
                                     error_feedback=False)
    b = sparse.sparse_allreduce_topk(ones, name="u.tie", ratio=0.1,
                                     error_feedback=False)
    assert torch.equal(a, b) and int((a != 0).sum()) == 6
    empty = sparse.sparse_allreduce_topk(torch.zeros(0, 3), name="u.e")
    assert empty.shape == (0, 3)


def test_eager_allreduce_routes_topk_and_wire(port_one):
    """``test_compression.py:101``, and the routes' refusals."""
    from horovod_tpu_torch.runtime import sparse

    hvd = port_one
    x = torch.zeros(50)
    x[7], x[9] = 2.0, 0.5
    out = hvd.allreduce(x, compression=hvd.Compression.topk(0.02),
                        name="eg.t")
    assert out[7] == 2.0 and out[9] == 0.0
    assert sparse.residual_norm("eg.t") == pytest.approx(0.5)
    assert torch.equal(hvd.allreduce(x, compression=hvd.Compression
                                     .wire_int8), x)
    # bf16 in, bf16 out; Sum keeps the sum.
    xb = x.to(torch.bfloat16)
    ob = hvd.allreduce(xb, op=hvd.Sum, compression=hvd.Compression.topk(
        0.02), name="eg.b")
    assert ob.dtype == torch.bfloat16 and float(ob[7]) == 2.0
    # Grouped: per-leaf names '<name>.<i>'.
    outs = hvd.grouped_allreduce([x, 2 * x], name="eg.g",
                                 compression=hvd.Compression.topk(0.02))
    assert [float(o[7]) for o in outs] == [2.0, 4.0]
    assert sparse.residual_norm("eg.g.1") == pytest.approx(1.0)
    with pytest.raises(ValueError, match="stable per-tensor name"):
        hvd.allreduce(x, compression=hvd.Compression.topk(0.1))
    with pytest.raises(ValueError, match="requires name="):
        hvd.grouped_allreduce([x], compression=hvd.Compression.topk(0.1))
    with pytest.raises(NotImplementedError, match="SUM/AVERAGE only"):
        hvd.allreduce(x, op=hvd.Max, name="eg.m",
                      compression=hvd.Compression.topk(0.1))
    with pytest.raises(ValueError, match="wire_dtypes"):
        hvd.grouped_allreduce([x, x], wire_dtypes=["int8"])


def test_distributed_optimizer_topk_residual_per_leaf(port_one):
    """``test_compression.py:121``: the JAX form keeps one residual per
    gradient leaf, named by its tree path."""
    from horovod_tpu_torch.runtime import sparse

    hvd = port_one
    dense = torch.nn.Parameter(torch.zeros(100))
    bias = torch.nn.Parameter(torch.zeros(10))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([dense, bias], lr=0.1),
        named_parameters=[("dense", dense), ("bias", bias)],
        compression=hvd.Compression.topk(0.01))
    dense.grad = torch.zeros(100)
    dense.grad[4], dense.grad[5] = 3.0, 0.25
    bias.grad = torch.zeros(10)
    bias.grad[1] = 1.0
    opt.synchronize()
    assert dense.grad[4] == 3.0 and dense.grad[5] == 0.0
    assert bias.grad[1] == 1.0
    assert sparse.residual_norm("grad['dense']") == pytest.approx(0.25)
    assert "grad['bias']" in sparse._RESIDUALS
    # Without names: the i-th leaf of the list.
    g = [torch.ones(4), torch.ones(3)]
    hvd.allreduce_gradients(g, compression=hvd.Compression.topk(0.5))
    assert sorted(k for k in sparse._RESIDUALS if k[5].isdigit()) \
        == ["grad[0]", "grad[1]"]


def _policy_grads(step):
    """``wire_policy_worker.py``'s gradients of one step, for rank 0, with
    the weights at zero: a smooth matrix and a bias, and a spiky one."""
    rng = np.random.default_rng(4321)
    w_true = (rng.standard_normal((256, 256)) / 16.0).astype(np.float32)
    b_true = rng.standard_normal(256).astype(np.float32)
    rng_r = np.random.default_rng(99 + step)
    x = rng_r.standard_normal((128, 256)).astype(np.float32)
    r = -(x @ w_true + b_true)
    gw = ((2.0 / 128) * (x.T @ r)).astype(np.float32)
    gb = ((2.0 / 128) * r.sum(axis=0)).astype(np.float32)
    spiky = np.full((300, 300), 1e-3, np.float32)
    spiky[step, 7] = 50.0
    return {"gw": gw, "gb": gb, "spiky": spiky,
            "small": gw[:4, :4].copy(), "half": gw.astype(np.float16)}


def test_wire_policy_statistics_and_decisions_match_the_reference():
    from horovod_tpu.runtime.wire_policy import WirePolicy as RefPolicy
    from horovod_tpu_torch.runtime.wire_policy import (WirePolicy,
                                                       leaf_statistics)

    ref, port = RefPolicy(min_elems=64), WirePolicy(min_elems=64)
    for step in range(6):
        grads = _policy_grads(step)
        names = sorted(grads)
        want = [ref.observe_and_choose(n, grads[n]) for n in names]
        got = port.observe_and_choose_many(
            names, [torch.from_numpy(grads[n]) for n in names])
        assert got == want, (step, got, want)
        for n in ("gw", "spiky"):
            a, m = leaf_statistics([torch.from_numpy(grads[n])])[0]
            assert a == float(np.max(np.abs(grads[n])))
            ms = float(np.mean(np.square(grads[n])))
            assert abs(m - ms) <= 1e-6 * ms, (n, m, ms)
            assert port._stats[n].rms == pytest.approx(ref._stats[n].rms,
                                                       rel=1e-6)
    assert port.decisions == ref.decisions
    assert port.decisions == {"gb": "fp32", "gw": "int8", "half": None,
                              "small": "fp32", "spiky": None}
    assert port.observe_and_choose("gw", torch.from_numpy(
        _policy_grads(7)["gw"])) == "int8"


# -- worlds of 2 ranks -------------------------------------------------------


def _model(seed=5):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 9), torch.nn.Tanh(),
                               torch.nn.Linear(9, 3))


def _loss(m, step, rank):
    rng = np.random.default_rng(1000 * step + rank)
    x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    return ((m(x) - y) ** 2).mean()


def _flat(params):
    return np.concatenate([p.detach().reshape(-1).numpy() for p in params])


def _hook_program(mod, Compression, rank):
    """The hook form's top-k, top-k without feedback, top-k local SGD and
    policy cases; the same calls on either side (``mod``:
    ``horovod_tpu.torch`` or the port's ``torch_frontend``)."""
    out = {}
    cases = {"topk": (dict(compression=Compression.topk(0.3)), STEPS),
             "topk_nofb": (dict(compression=Compression.topk(
                 0.3, error_feedback=False)), STEPS),
             "topk_local_sgd": (dict(compression=Compression.topk(0.5),
                                     local_sgd_steps=2), 2 * STEPS),
             "policy": ({}, POLICY_STEPS)}
    for tag, (kw, steps) in cases.items():
        m = _model()
        if tag == "policy":
            os.environ["HOROVOD_WIRE_POLICY"] = "1"
        try:
            opt = mod.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=LR, momentum=0.9),
                named_parameters=[(f"{tag}.{n}", p)
                                  for n, p in m.named_parameters()], **kw)
        finally:
            os.environ.pop("HOROVOD_WIRE_POLICY", None)
        for step in range(steps):
            opt.zero_grad()
            _loss(m, step, rank).backward()
            opt.step()
            out[f"{tag}.params.{step}"] = _flat(m.parameters())
        if tag == "policy":
            decided = opt._wire_policy.decisions
            out["policy.decisions"] = np.array(
                [f"{n}={decided.get(n)}" for n in sorted(decided)])
    return out


def _jf_params():
    rng = np.random.default_rng(7)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in JF_SHAPES.items()}


def _jf_grads(step, rank):
    rng = np.random.default_rng(500 + 10 * step + rank)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in JF_SHAPES.items()}


def _jf_port_program(hvd, rank):
    """The JAX form's top-k and policy routes, on parameters whose loss is
    ``sum(p * G)``."""
    out = {}
    for case, steps in (("topk", STEPS), ("policy", POLICY_STEPS)):
        named = [(n, torch.nn.Parameter(torch.from_numpy(v)))
                 for n, v in _jf_params().items()]
        kw = ({"compression": hvd.Compression.topk(0.3)}
              if case == "topk" else {})
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([p for _, p in named], lr=LR),
            named_parameters=named, **kw)
        for step in range(steps):
            g = _jf_grads(step, rank)
            opt.zero_grad()
            sum((p * torch.from_numpy(g[n])).sum()
                for n, p in named).backward()
            if case == "policy":
                os.environ["HOROVOD_WIRE_POLICY"] = "1"
            try:
                opt.step()
            finally:
                os.environ.pop("HOROVOD_WIRE_POLICY", None)
        out[f"jf.{case}"] = _flat(p for _, p in named)
    return out


def _jf_jax_program(rank):
    import jax.numpy as jnp
    import optax
    import horovod_tpu.jax as hvd

    def tree(d):
        return {"a": {"b": jnp.asarray(d["a.b"]), "w": jnp.asarray(d["a.w"])},
                "b": {"w": jnp.asarray(d["b.w"])}}

    out = {}
    for case, steps in (("topk", STEPS), ("policy", POLICY_STEPS)):
        params = tree(_jf_params())
        kw = ({"compression": hvd.Compression.topk(0.3)}
              if case == "topk" else {})
        opt = hvd.DistributedOptimizer(optax.sgd(LR), **kw)
        state = opt.init(params)
        for step in range(steps):
            if case == "policy":
                os.environ["HOROVOD_WIRE_POLICY"] = "1"
            try:
                updates, state = opt.update(tree(_jf_grads(step, rank)),
                                            state, params)
            finally:
                os.environ.pop("HOROVOD_WIRE_POLICY", None)
            params = optax.apply_updates(params, updates)
        out[f"jf.{case}"] = np.concatenate([
            np.asarray(params["a"]["w"]).ravel(),
            np.asarray(params["a"]["b"]).ravel(),
            np.asarray(params["b"]["w"]).ravel()])
    return out


def _local_sgd_topk(LocalSGD, spec, wrap, unwrap, residual_norm, rank):
    """``local_sgd_worker.scenario_topk``: H 8, ratio 0.5, 10 rounds on
    the quadratic, numpy local steps; the model after each sync."""
    h, rounds, lr, dim = 8, 10, 0.05, 8
    target = np.linspace(rank + 1.0, rank + 2.0, dim)
    policy = LocalSGD(local_sgd_steps=h, compression=spec)
    w = np.zeros(dim, dtype=np.float32)
    policy.begin({"w": wrap(w)})
    out, saw_residual = {}, False
    for step in range(h * rounds):
        w = (w - lr * 2.0 * (w - target)).astype(np.float32)
        tree = {"w": wrap(w)}
        synced = policy.maybe_sync(tree)
        if synced is not tree:
            w = unwrap(synced["w"])
            out[f"lsgd.w.{step}"] = w.copy()
            saw_residual = (saw_residual or
                            residual_norm("local_sgd.delta.p.w") > 0)
    out["lsgd.syncs"] = np.array(policy.sync_count)
    out["lsgd.saw_residual"] = np.array(saw_residual)
    return out


def _sparse_world(sparse, rank):
    """3 steps of one named tensor with residuals; the inputs and the
    2-rank outputs."""
    rng = np.random.default_rng(40 + rank)
    out = {}
    for step in range(3):
        x = _tie_free(rng, 700)
        out[f"sw.x.{step}"] = x
        out[f"sw.out.{step}"] = sparse.sparse_allreduce_topk(
            torch.from_numpy(x), name="sw", ratio=0.05).numpy()
    return out


def _wire_sparse(sparse, eng, rank, size):
    """``native_worker.scenario_wire_sparse`` on the port."""
    n = 1000
    x = torch.zeros(n)
    x[7] = 10.0 + rank
    x[1:4] = 0.25
    s0 = eng.stats()["sparse_count"]
    out = sparse.sparse_allreduce_topk(x, name="sp.t", ratio=0.001)
    assert float(out[7]) == float(np.mean([10.0 + r for r in range(size)]))
    assert bool((out[1:4] == 0.0).all())
    assert sparse.residual_norm("sp.t") > 0.0
    assert eng.stats()["sparse_count"] - s0 == 1
    out2 = sparse.sparse_allreduce_topk(torch.zeros(n), name="sp.t",
                                        ratio=0.001)
    assert float(out2.abs().sum()) > 0.0, "residual never drained"
    sparse.sparse_allreduce_topk(x, name="sp.nef", ratio=0.001,
                                 error_feedback=False)
    assert sparse.residual_norm("sp.nef") == 0.0
    return {"wire_sparse.ok": np.array(True)}


def _convergence(sparse, eng, rank, size):
    """``compression_worker.py`` on the port's engine: the losses of the
    fp32, int8, top-k and no-feedback runs."""
    dim, m, steps, lr = 256, 256, 250, 0.05
    rng = np.random.default_rng(1234)
    w_true = rng.standard_normal(dim).astype(np.float32)
    shards = []
    for r in range(size):
        rng_r = np.random.default_rng(77 + r)
        X = rng_r.standard_normal((m, dim)).astype(np.float32)
        y = X @ w_true + 0.01 * rng_r.standard_normal(m).astype(np.float32)
        shards.append((X, y))

    def loss(w):
        return sum(float((X @ w - y) @ (X @ w - y)) for X, y in shards) \
            / (m * size)

    X, y = shards[rank]
    losses = {}
    for mode in ("fp32", "int8", "topk", "nofb"):
        sparse.reset_residuals()
        w = np.zeros(dim, dtype=np.float32)
        for step in range(steps):
            grad = torch.from_numpy(
                ((2.0 / m) * (X.T @ (X @ w - y))).astype(np.float32))
            name = f"conv.{mode}.g"
            if mode in ("fp32", "int8"):
                g = eng.synchronize(eng.enqueue_allreduce(
                    grad, name=f"{name}.{step}",
                    wire_dtype="int8" if mode == "int8" else None)) / size
            else:
                g = sparse.sparse_allreduce_topk(
                    grad, name=name, ratio=0.01,
                    error_feedback=mode == "topk")
            w -= lr * g.numpy()
        losses[mode] = loss(w)
    losses["init"] = loss(np.zeros(dim, np.float32))
    return {f"conv.{k}": np.array(v) for k, v in losses.items()}


def _policy_bounds(WirePolicy, eng, rank, size):
    """``wire_policy_worker.py`` on the port's engine: data bytes sent and
    the losses of the fp32 and policy runs, and the policy's decisions."""
    dim, n_out, m, steps, lr = 256, 256, 128, 120, 0.05
    rng = np.random.default_rng(4321)
    w_true = (rng.standard_normal((dim, n_out)) / np.sqrt(dim)).astype(
        np.float32)
    b_true = rng.standard_normal(n_out).astype(np.float32)
    shards = []
    for r in range(size):
        rng_r = np.random.default_rng(99 + r)
        X = rng_r.standard_normal((m, dim)).astype(np.float32)
        y = (X @ w_true + b_true + 0.01 * rng_r.standard_normal(
            (m, n_out))).astype(np.float32)
        shards.append((X, y))
    X, y = shards[rank]
    out = {}
    for mode in ("fp32", "policy"):
        policy = WirePolicy(min_elems=65536) if mode == "policy" else None
        w = np.zeros((dim, n_out), np.float32)
        b = np.zeros(n_out, np.float32)
        tx0 = eng.stats()["data_bytes_tx"]
        for step in range(steps):
            r = X @ w + b - y
            gw = torch.from_numpy(((2.0 / m) * (X.T @ r)).astype(np.float32))
            gb = torch.from_numpy(((2.0 / m) * r.sum(axis=0)).astype(
                np.float32))
            wires = ([None, None] if policy is None else
                     policy.observe_and_choose_many(["wp.gw", "wp.gb"],
                                                    [gw, gb]))
            hs = [eng.enqueue_allreduce(t, name=f"wp.{mode}.{k}",
                                        wire_dtype=wd,
                                        wire_advisory=wd is not None)
                  for t, k, wd in ((gw, "gw", wires[0]),
                                   (gb, "gb", wires[1]))]
            ow, ob = (eng.synchronize(h) for h in hs)
            w -= lr * (ow.numpy() / size)
            b -= lr * (ob.numpy() / size)
        out[f"wp.tx.{mode}"] = np.array(eng.stats()["data_bytes_tx"] - tx0)
        out[f"wp.loss.{mode}"] = np.array(sum(
            float(((Xs @ w + b - ys) ** 2).sum()) for Xs, ys in shards)
            / (size * m * n_out))
        if policy is not None:
            out["wp.decisions"] = np.array(
                [policy.decisions["wp.gw"], policy.decisions["wp.gb"]])
    out["wp.int8_count"] = np.array(eng.stats()["wire_int8_count"])
    return out


class _DuckTopK:
    """A top-k spec by duck type (what the reference's LocalSGD detects)."""

    def __init__(self, ratio, error_feedback=True):
        self.ratio, self.error_feedback = ratio, error_feedback


_DuckTopK.__name__ = "TopKCompressor"


def _rank_main(mode: str, dst: str) -> None:
    """One rank: ``python tests/test_torch_port_sparse.py MODE OUT.npz``.
    ``port``: every port program; ``ref``: the reference torch frontend's
    and LocalSGD's; ``jax``: ``horovod_tpu.jax``'s JAX-form programs."""
    if mode == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu.jax as hvd

        hvd.init()
        out = _jf_jax_program(hvd.rank())
    elif mode == "ref":
        import horovod_tpu.torch as mod
        from horovod_tpu.elastic import LocalSGD
        from horovod_tpu.runtime import sparse
        from horovod_tpu.torch.compression import Compression

        mod.init()
        out = _hook_program(mod, Compression, mod.rank())
        sparse.reset_residuals()
        out.update(_local_sgd_topk(LocalSGD, _DuckTopK(0.5), lambda w: w,
                                   np.asarray, sparse.residual_norm,
                                   mod.rank()))
        mod.shutdown()
    else:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import torch_frontend
        from horovod_tpu_torch.elastic import LocalSGD
        from horovod_tpu_torch.runtime import sparse
        from horovod_tpu_torch.runtime.engine import get_engine
        from horovod_tpu_torch.runtime.wire_policy import WirePolicy

        hvd.init(device="cpu")
        eng, rank, size = get_engine(), hvd.rank(), hvd.size()
        s0 = eng.stats()
        out = _hook_program(torch_frontend, hvd.Compression, rank)
        out.update(_jf_port_program(hvd, rank))
        sparse.reset_residuals()
        c0 = eng.stats()
        out.update(_local_sgd_topk(
            LocalSGD, hvd.Compression.topk(0.5),
            lambda w: torch.from_numpy(w.copy()), lambda t: t.numpy(),
            sparse.residual_norm, rank))
        c1 = eng.stats()
        out["lsgd.counters"] = np.array([
            c1[k] - c0[k] for k in ("local_sgd_syncs", "sparse_count")])
        sparse.reset_residuals()
        out.update(_sparse_world(sparse, rank))
        out.update(_wire_sparse(sparse, eng, rank, size))
        out.update(_convergence(sparse, eng, rank, size))
        out.update(_policy_bounds(WirePolicy, eng, rank, size))
        out["sparse_count"] = np.array(eng.stats()["sparse_count"]
                                       - s0["sparse_count"])
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "horovod_tpu"))
        assert not bad, bad
        hvd.shutdown()
    np.savez(dst, **out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's, the reference torch frontend's and the JAX package's
    worlds of 2 ranks, run together: {mode: [rank outputs]}."""
    from test_torch_port_engine import _finish, _free_port

    tmp = tmp_path_factory.mktemp("sparse")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
    env.update(PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests"),
               JAX_PLATFORMS="cpu", HOROVOD_FUSION_THRESHOLD="0",
               HOROVOD_WIRE_POLICY_MIN_ELEMS=POLICY_MIN_ELEMS)
    started = {}
    for mode in ("port", "ref", "jax"):
        outs = [tmp / f"{mode}.{r}.npz" for r in range(2)]
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(outs[r])],
            env=dict(env, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                     HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                     HOROVOD_COORDINATOR=coord),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        started[mode] = (procs, outs)
    return {mode: _finish(w, timeout=300) for mode, w in started.items()}


def test_two_rank_output_is_the_rank_order_sum_of_the_selections(worlds):
    """Each rank's selection through the reference at a world of one (its
    own residual), summed in fp64 in rank order, halved, rounded to fp32:
    the port's 2-rank output, bit for bit, at every step."""
    ref = _ref_sparse()
    got = worlds["port"]
    for step in range(3):
        sel = [ref.sparse_allreduce_topk(got[r][f"sw.x.{step}"],
                                         name=f"sw.{r}", ratio=0.05,
                                         average=False) for r in range(2)]
        want = ((sel[0].astype(np.float64) + sel[1].astype(np.float64))
                / 2).astype(np.float32)
        for r in range(2):
            assert got[r][f"sw.out.{step}"].tobytes() == want.tobytes(), \
                (r, step)
    ref.reset_residuals()


def test_wire_sparse_scenario(worlds):
    """``test_compression.py:236``: the port's ranks asserted it."""
    assert all(bool(w["wire_sparse.ok"]) for w in worlds["port"])


_HOOK_CASES = {"topk": STEPS, "topk_nofb": STEPS,
               "topk_local_sgd": 2 * STEPS, "policy": POLICY_STEPS}


@pytest.mark.parametrize("case", sorted(_HOOK_CASES))
def test_hook_form_matches_the_reference_bitwise(worlds, case):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        for step in range(_HOOK_CASES[case]):
            key = f"{case}.params.{step}"
            assert got[r][key].tobytes() == want[r][key].tobytes(), (r, key)
    last = f"{case}.params.{_HOOK_CASES[case] - 1}"
    assert got[0][last].tobytes() == got[1][last].tobytes()
    if case == "topk_local_sgd":
        # The ranks part between syncs (every second step).
        assert got[0][f"{case}.params.0"].tobytes() != \
            got[1][f"{case}.params.0"].tobytes()


def test_hook_form_policy_decisions_match_the_reference(worlds):
    got, want = worlds["port"], worlds["ref"]
    for r in range(2):
        assert got[r]["policy.decisions"].tolist() == \
            want[r]["policy.decisions"].tolist()
    decided = dict(s.split("=") for s in got[0]["policy.decisions"])
    assert decided == {"policy.0.bias": "fp32", "policy.0.weight": "int8",
                       "policy.2.bias": "fp32", "policy.2.weight": "int8"}


@pytest.mark.parametrize("case", ["topk", "policy"])
def test_jax_form_routes_match_the_jax_package(worlds, case):
    got, want = worlds["port"], worlds["jax"]
    for r in range(2):
        np.testing.assert_allclose(got[r][f"jf.{case}"],
                                   want[r][f"jf.{case}"], rtol=0, atol=1e-6)
    assert got[0][f"jf.{case}"].tobytes() == got[1][f"jf.{case}"].tobytes()


def test_local_sgd_topk_matches_the_reference(worlds):
    """``local_sgd_worker.py topk``: bitwise against the reference's
    LocalSGD, 10 syncs, each one sparse allreduce, residuals in use, and
    the loss bound."""
    got, want = worlds["port"], worlds["ref"]
    keys = sorted(k for k in want[0] if k.startswith("lsgd.w."))
    assert len(keys) == 10
    for r in range(2):
        for k in keys + ["lsgd.syncs", "lsgd.saw_residual"]:
            assert got[r][k].tobytes() == want[r][k].tobytes(), (r, k)
        assert got[r]["lsgd.counters"].tolist() == [10, 10]
        assert bool(got[r]["lsgd.saw_residual"])
    w = got[0][keys[-1]]
    tbar = np.mean([np.linspace(r + 1.0, r + 2.0, 8) for r in range(2)],
                   axis=0)
    assert float(np.mean((w - tbar) ** 2)) <= 0.10


def test_compression_convergence_bounds(worlds):
    """``compression_worker.py``'s pinned bounds on the port."""
    for rank_out in worlds["port"]:
        c = {k[5:]: float(v) for k, v in rank_out.items()
             if k.startswith("conv.")}
        assert c["fp32"] < 0.05, c
        assert c["int8"] <= c["fp32"] * 3.0 + 0.02, c
        assert c["topk"] <= 12.0 and c["topk"] <= c["init"] / 20.0, c
        assert c["nofb"] >= c["topk"] * 1.5, c
        assert c["nofb"] >= c["topk"] + 0.02, c


def test_wire_policy_bounds(worlds):
    """``wire_policy_worker.py``'s bounds on the port."""
    for o in worlds["port"]:
        ratio = float(o["wp.tx.policy"]) / float(o["wp.tx.fp32"])
        assert ratio <= 0.60, ratio
        assert float(o["wp.loss.fp32"]) < 0.05
        assert float(o["wp.loss.policy"]) <= \
            float(o["wp.loss.fp32"]) * 3.0 + 0.02
        assert o["wp.decisions"].tolist() == ["int8", "fp32"]
        assert int(o["wp.int8_count"]) > 0


def test_sparse_count_counts_every_sparse_allreduce(worlds):
    """Every top-k reduction of the port's programs counted once."""
    # Hook form: 4 leaves x 3 steps (topk, topk_nofb); local SGD: 4
    # leaves x 3 syncs; JAX form: 3 leaves x 3 steps; LocalSGD: 10 syncs;
    # the world of residuals: 3; wire_sparse: 3; convergence: 500.
    want = 4 * 3 * 2 + 4 * 3 + 3 * 3 + 10 + 3 + 3 + 2 * 250
    assert [int(o["sparse_count"]) for o in worlds["port"]] == [want] * 2


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])

"""Port parity: the device-plane collectives (``ops/collective_ops.py``)
and the frontend's dispatch into them inside a step.

Every function of ``horovod_tpu_torch.ops.collective_ops`` on gloo ranks
(this file run as a script per rank, ``_rank_main``: one world of 2 and
one of 4, started together, every case run inside them) against the
reference's function of the same name under ``shard_map`` on a sub-mesh
of the conftest's CPU devices of the same size, on the same seeded numpy
inputs, a different one on each rank:

* every ``ReduceOp`` of ``allreduce`` on fp32, bf16 and int32;
  ``allgather`` and ``reducescatter`` at axis 0 and 1, ``reducescatter``
  with ``tiled=False`` and ``Average``; ``alltoall`` at (0, 0), (1, 0)
  and (0, 1); ``broadcast`` from rank 1 on fp32, bf16 and int32;
  ``grouped_allreduce`` on the reference's mixed-dtype case
  (``tests/test_collectives.py:186``) under a 32-byte fusion threshold,
  so that it spans several buckets; a tuple ``axis_name`` on a 2 x 2 mesh;
  an axis of size 1 (``{"data": 2, "fsdp": 1}``); ``axis_rank`` and
  ``axis_size``.
* Tolerance: bit for bit, every case, at 2 and at 4 ranks (the port sums
  in rank order with fp32 accumulation for bf16, as the reference's
  ``psum`` does on the CPU); the dtype of each result equals the
  reference's (``Average`` of int32 is fp32).
* Gradients of every differentiable case, fp32, ``x.grad`` of
  ``sum(f(x) * w)`` with a seeded cotangent ``w`` on each rank, against
  ``jax.grad`` of the same inside ``shard_map(check_vma=False)`` (the
  reference's ``make_train_step``): within 1e-6, absolute and relative.
  ``Min`` and ``Max`` have no differentiation rule in JAX; the port's
  backward raises the same ``NotImplementedError``.

Dispatch: ``hvd.make_train_step`` and ``make_parallel_train_step``
(mesh ``{"data": 2}``) with a loss that calls ``hvd.allgather`` (an
in-batch contrastive loss over every rank's embeddings) and
``hvd.allreduce``, 3 SGD steps on 2 ranks, against the reference's
``make_train_step`` with the same collectives in its loss: losses and
parameters within rtol 1e-5 (``tests/test_torch_port_train.py``'s); the
steps move ``comm.stats`` and no engine response.  Outside a step the
same names, ``keras.impl.average_tensors`` and the examples' call form
take the engine: bitwise the direct ``runtime/eager.py`` call, responses
move, ``comm.stats`` does not.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-6
STEP_RTOL = 1e-5
STEPS, LR, ROWS, D_IN, D_EMB = 3, 0.1, 4, 8, 16
GROUPED_SHAPES = [((3,), "float32"), ((2, 2), "float32"),
                  ((5, 1), "float32"), ((1,), "float32"),
                  ((4, 3), "float32"), ((7,), "bfloat16")]
FUSION_BYTES = "32"


def _case(cid, fn, dtype="float32", shape=(3, 5), grad=True, worlds=(2, 4),
          mesh=None, pinned=False, **kw):
    return cid, dict(fn=fn, dtype=dtype, shape=shape, grad=grad,
                     worlds=worlds, mesh=mesh, pinned=pinned, kw=kw)


def _cases():
    out = []
    for op in ("Sum", "Average", "Min", "Max", "Product"):
        for dt in ("float32", "bfloat16", "int32"):
            grad = ("raises" if op in ("Min", "Max") else True) \
                if dt == "float32" else False
            out.append(_case(f"allreduce_{op}_{dt}", "allreduce", dt,
                             grad=grad, op=op))
    out.append(_case("allreduce_average_kw", "allreduce", average=False))
    for ax in (0, 1):
        out.append(_case(f"allgather_ax{ax}", "allgather", shape=(2, 3),
                         axis=ax))
    out.append(_case("allgather_bf16", "allgather", "bfloat16", (2, 3),
                     grad=False, axis=1))
    out.append(_case("allgather_int32", "allgather", "int32", (2, 3),
                     grad=False))
    for ax in (0, 1):
        out.append(_case(f"reducescatter_ax{ax}", "reducescatter",
                         shape=("n2", "n3"), op="Sum", scatter_axis=ax))
    out.append(_case("reducescatter_average", "reducescatter",
                     shape=("n2", 3), op="Average"))
    out.append(_case("reducescatter_untiled", "reducescatter",
                     shape=(3, "n"), scatter_axis=1, tiled=False))
    out.append(_case("reducescatter_bf16", "reducescatter", "bfloat16",
                     ("n2", "n3"), grad=False, scatter_axis=1))
    out.append(_case("reducescatter_int32", "reducescatter", "int32",
                     ("n2", 3), grad=False))
    out.append(_case("reducescatter_int32_average", "reducescatter",
                     "int32", ("n2", 3), grad=False, op="Average"))
    for sa, ca in ((0, 0), (1, 0), (0, 1)):
        out.append(_case(f"alltoall_{sa}{ca}", "alltoall",
                         shape=("n2", "n3"), axis_name="data",
                         split_axis=sa, concat_axis=ca))
    out.append(_case("alltoall_bf16", "alltoall", "bfloat16", ("n2", 3),
                     grad=False, axis_name="data"))
    for dt in ("float32", "bfloat16", "int32"):
        out.append(_case(f"broadcast_root1_{dt}", "broadcast", dt,
                         grad=dt == "float32", root_rank=1))
    out.append(_case("broadcast_root0", "broadcast", root_rank=0))
    out.append(_case("broadcast_negzero", "broadcast", grad=False,
                     worlds=(2,), root_rank=1, pinned=True))
    out.append(_case("grouped_mixed", "grouped_allreduce", "mixed",
                     grad=False, op="Sum"))
    out.append(_case("grouped_average", "grouped_allreduce", "float32",
                     op="Average"))
    out.append(_case("axis_rank_size", "axis", grad=False))
    # a tuple axis_name on a 2 x 2 mesh
    tup = {"data": 2, "fsdp": 2}
    name = ("data", "fsdp")
    out.append(_case("tuple_allreduce", "allreduce", worlds=(4,), mesh=tup,
                     axis_name=name, op="Sum"))
    out.append(_case("tuple_allreduce_fsdp", "allreduce", worlds=(4,),
                     mesh=tup, axis_name="fsdp", op="Sum"))
    out.append(_case("tuple_allgather", "allgather", shape=(2, 3),
                     worlds=(4,), mesh=tup, axis_name=name, axis=1))
    out.append(_case("tuple_reducescatter", "reducescatter",
                     shape=(8, 3), worlds=(4,), mesh=tup, axis_name=name))
    out.append(_case("tuple_alltoall", "alltoall", shape=(8, 4),
                     worlds=(4,), mesh=tup, axis_name=name, split_axis=1))
    out.append(_case("tuple_broadcast", "broadcast", worlds=(4,), mesh=tup,
                     axis_name=name, root_rank=2))
    out.append(_case("tuple_axis", "axis", grad=False, worlds=(4,),
                     mesh=tup, axis_name=name))
    # an axis of size 1
    one = {"data": 2, "fsdp": 1}
    for op in ("Sum", "Product"):
        out.append(_case(f"size1_allreduce_{op}", "allreduce", worlds=(2,),
                         mesh=one, axis_name="fsdp", op=op))
    out.append(_case("size1_allgather", "allgather", worlds=(2,), mesh=one,
                     axis_name="fsdp", axis=1))
    out.append(_case("size1_reducescatter", "reducescatter", shape=(1, 3),
                     worlds=(2,), mesh=one, axis_name="fsdp", tiled=False))
    out.append(_case("size1_alltoall", "alltoall", worlds=(2,), mesh=one,
                     axis_name="fsdp", split_axis=1))
    out.append(_case("size1_broadcast", "broadcast", worlds=(2,), mesh=one,
                     axis_name="fsdp"))
    out.append(_case("size1_axis", "axis", grad=False, worlds=(2,), mesh=one,
                     axis_name="fsdp"))
    return dict(out)


CASES = _cases()
RUNS = [(cid, n) for cid, c in CASES.items() for n in c["worlds"]]


def _shape(case, n):
    return tuple(n * int(d[1:] or 1) if isinstance(d, str) else d
                 for d in case["shape"])


def _draw(rng, shape, dtype, n):
    """Inputs of ``n`` ranks: [n, *shape] (small integers for int32, so
    that a product of 4 stays exact)."""
    if dtype == "int32":
        return rng.integers(-3, 4, (n,) + shape).astype(np.int32)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    if dtype == "bfloat16":       # values a bf16 holds exactly
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _inputs(cid, n):
    """{name: [n, ...] array} of one case: ``x`` (or ``x0``.. for a
    grouped case) and the cotangent ``w`` of a differentiable case."""
    case = CASES[cid]
    rng = np.random.default_rng([sorted(CASES).index(cid), n])
    if case["fn"] == "grouped_allreduce":
        shapes = (GROUPED_SHAPES if case["dtype"] == "mixed"
                  else [(s, "float32") for s, _ in GROUPED_SHAPES])
        out = {f"x{i}": _draw(rng, s, d, n) for i, (s, d) in
               enumerate(shapes)}
        if case["grad"]:
            out.update({f"w{i}": _draw(rng, s, d, n) for i, (s, d) in
                        enumerate(shapes)})
        return out
    out = {"x": _draw(rng, _shape(case, n), case["dtype"], n)}
    if case["pinned"]:          # the root's zeros negative
        out["x"][1, 0, :] = -0.0
    if case["grad"] is not False:
        out["w"] = rng.standard_normal(
            (n,) + _out_shape(case, n)).astype(np.float32)
    return out


def _out_shape(case, n):
    shape = list(_shape(case, n))
    kw = case["kw"]
    size = n
    if case["mesh"] is not None:
        names = kw.get("axis_name")
        names = (names,) if isinstance(names, str) else names
        size = int(np.prod([case["mesh"][a] for a in names]))
    if case["fn"] == "allgather":
        shape[kw.get("axis", 0)] *= size
    elif case["fn"] == "reducescatter":
        ax = kw.get("scatter_axis", 0)
        shape[ax] //= size
        if kw.get("tiled", True) is False:
            del shape[ax]
    elif case["fn"] == "alltoall":
        shape[kw.get("split_axis", 0)] //= size
        shape[kw.get("concat_axis", 0)] *= size
    return tuple(shape)


def _kwargs(kw, ops):
    return {k: getattr(ops, v) if k == "op" else v for k, v in kw.items()}


# ---------------------------------------------------------------------------
# the port's side: one rank
# ---------------------------------------------------------------------------

def _port_case(cid, arrays, rank, hvd):
    """{key: array} of one case on this rank: ``out`` (fp32 for bf16, and
    its ``dtype``), ``grad`` or ``grad_error``, ``calls``."""
    from horovod_tpu_torch.ops import collective_ops as cops
    from horovod_tpu_torch.parallel import comm

    case = CASES[cid]
    kw = _kwargs(case["kw"], cops)

    def tensor(a, dtype):
        t = torch.from_numpy(a[rank].copy())
        return t.bfloat16() if dtype == "bfloat16" else t

    res = {}
    comm.reset_stats()
    if case["fn"] == "axis":
        name = kw.get("axis_name", "data")
        res["out"] = np.array([cops.axis_rank(name), cops.axis_size(name)])
        return res
    if case["fn"] == "grouped_allreduce":
        shapes = (GROUPED_SHAPES if case["dtype"] == "mixed"
                  else [(s, "float32") for s, _ in GROUPED_SHAPES])
        xs = [tensor(arrays[f"x{i}"], d).requires_grad_(bool(case["grad"]))
              for i, (_, d) in enumerate(shapes)]
        prev = os.environ.get("HOROVOD_FUSION_THRESHOLD")
        os.environ["HOROVOD_FUSION_THRESHOLD"] = FUSION_BYTES
        try:
            outs = cops.grouped_allreduce(xs, **kw)
        finally:
            if prev is None:
                del os.environ["HOROVOD_FUSION_THRESHOLD"]
            else:
                os.environ["HOROVOD_FUSION_THRESHOLD"] = prev
        res["calls"] = np.array(comm.stats["calls"])
        for i, o in enumerate(outs):
            res[f"out{i}"] = o.detach().float().numpy()
            res[f"dtype{i}"] = np.array(str(o.dtype).split(".")[1])
        if case["grad"]:
            sum((o * tensor(arrays[f"w{i}"], "float32")).sum()
                for i, o in enumerate(outs)).backward()
            for i, x in enumerate(xs):
                res[f"grad{i}"] = x.grad.numpy()
        return res
    x = tensor(arrays["x"], case["dtype"])
    if case["grad"] is not False:
        x.requires_grad_(True)
    out = getattr(cops, case["fn"])(x, **kw)
    res["calls"] = np.array(comm.stats["calls"])
    res["out"] = out.detach().float().numpy()
    res["dtype"] = np.array(str(out.dtype).split(".")[1])
    if case["grad"] is not False:
        try:
            (out * torch.from_numpy(arrays["w"][rank])).sum().backward()
            res["grad"] = x.grad.numpy()
        except NotImplementedError as e:
            res["grad_error"] = np.array(str(e))
    return res


def _port_errors(hvd):
    """The shape and dtype checks: {check: the exception's type name}."""
    from horovod_tpu_torch.ops import collective_ops as cops

    n = hvd.size()
    checks = {
        "rs_untiled_len": lambda: cops.reducescatter(
            torch.ones(n + 1, 2), tiled=False),
        "rs_indivisible": lambda: cops.reducescatter(torch.ones(n + 1, 2)),
        "rs_min": lambda: cops.reducescatter(torch.ones(n, 2), op=cops.Min),
        "a2a_indivisible": lambda: cops.alltoall(torch.ones(n + 1, 2),
                                                 axis_name="data"),
        "bcast_bool": lambda: cops.broadcast(torch.ones(2, dtype=torch.bool)),
        "bcast_root": lambda: cops.broadcast(torch.ones(2), n),
        "no_axis": lambda: cops.allreduce(torch.ones(2), axis_name="seq"),
    }
    out = {}
    for name, fn in checks.items():
        try:
            fn()
            out[name] = "none"
        except Exception as e:  # noqa: BLE001 -- the type is the result
            out[name] = type(e).__name__
    return {f"err.{k}": np.array(v) for k, v in out.items()}


def _port_model(state):
    model = torch.nn.Linear(D_IN, D_EMB)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(state["w"].T))
        model.bias.copy_(torch.from_numpy(state["b"]))
    return model


def _contrastive(hvd, emb, rank):
    """Each row's logits against every rank's rows; its own row the
    label; plus the ranks' mean squared embedding."""
    from horovod_tpu_torch.ops.losses import softmax_cross_entropy

    every = hvd.allgather(emb)
    labels = torch.arange(emb.shape[0]) + rank * emb.shape[0]
    xent = softmax_cross_entropy(emb @ every.T / 4.0, labels)
    return xent + 0.1 * hvd.allreduce((emb * emb).mean())


def _port_steps(hvd, state, batch, parallel):
    """(losses, weight, bias, comm calls, engine responses) of 3 SGD
    steps of the contrastive loss through ``make_train_step`` (each rank
    its rows) or ``make_parallel_train_step`` (the global batch)."""
    from horovod_tpu_torch.parallel import comm
    from horovod_tpu_torch.parallel.api import make_parallel_train_step
    from horovod_tpu_torch.runtime.engine import get_engine

    rank = hvd.rank()
    model = _port_model(state)
    opt = torch.optim.SGD(model.parameters(), lr=LR)

    def loss_fn(model, x):
        return _contrastive(hvd, model(x), rank)

    x = torch.from_numpy(batch)
    if parallel:
        step = make_parallel_train_step(
            model, opt, hvd.build_mesh({"data": hvd.size()}),
            loss_fn=loss_fn)
    else:
        step = hvd.make_train_step(model, loss_fn, opt)
        x = x[rank * ROWS:(rank + 1) * ROWS]
    comm.reset_stats()
    responses = get_engine().stats()["responses"]
    losses = [float(step(x)) for _ in range(STEPS)]
    return (np.array(losses), model.weight.detach().numpy().T.copy(),
            model.bias.detach().numpy().copy(),
            np.array(comm.stats["calls"]),
            np.array(get_engine().stats()["responses"] - responses))


def _port_outside(hvd):
    """The frontend's names outside a step, the examples' call form and
    ``keras.impl.average_tensors``, each against the direct engine call:
    {key: array}."""
    from horovod_tpu_torch.keras import impl
    from horovod_tpu_torch.parallel import comm
    from horovod_tpu_torch.runtime import eager
    from horovod_tpu_torch.runtime.engine import get_engine

    rank, n = hvd.rank(), hvd.size()
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(2 * n, 3, generator=g)
    y = torch.randn(5, generator=g)
    calls = [
        ("allreduce", lambda m: m.allreduce(x, name="o.ar")),
        ("epoch_loss", lambda m: m.allreduce(x.mean(), name="o.epoch")),
        ("grouped", lambda m: m.grouped_allreduce([x, y], name="o.g")),
        ("allgather", lambda m: m.allgather(x, name="o.ag")),
        ("broadcast", lambda m: m.broadcast(x, 1, name="o.bc")),
        ("reducescatter", lambda m: m.reducescatter(x, name="o.rs")),
        ("alltoall", lambda m: m.alltoall(x, name="o.a2a")),
    ]
    out = {}
    comm.reset_stats()
    before = get_engine().stats()["responses"]
    for name, call in calls:
        got, want = call(hvd), call(eager)
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        out[f"outside.{name}"] = np.array(all(
            torch.equal(a, b) for a, b in zip(got, want)))
    avg = impl.average_tensors([x, y])
    out["outside.keras"] = np.array(
        torch.equal(avg[0], eager.allreduce(x, name="o.k")))
    out["outside.responses"] = np.array(
        get_engine().stats()["responses"] - before)
    out["outside.comm_calls"] = np.array(comm.stats["calls"])
    return out


def _port_inside_errors(hvd):
    """``splits=`` inside a step: the reference's NotImplementedError."""
    from horovod_tpu_torch.ops import collective_ops as cops

    with cops.in_step("data"):
        try:
            hvd.alltoall(torch.ones(hvd.size(), 2), splits=[1] * hvd.size())
        except NotImplementedError as e:
            return {"inside.splits": np.array(str(e))}
    return {"inside.splits": np.array("none")}


def _rank_main(src: str, dst: str) -> None:
    """One rank: every case of its world size; at 2 ranks, the dispatch
    parts too."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.mesh import use_mesh

    hvd.init(device="cpu")
    n, rank = hvd.size(), hvd.rank()
    data = np.load(src)
    out = {}
    for cid, c in CASES.items():
        if n not in c["worlds"]:
            continue
        pre = f"{cid}."
        arrays = {k[len(pre):]: data[k] for k in data.files
                  if k.startswith(pre)}
        if c["mesh"] is not None:
            with use_mesh(hvd.build_mesh(c["mesh"])):
                res = _port_case(cid, arrays, rank, hvd)
        else:
            res = _port_case(cid, arrays, rank, hvd)
        out.update({pre + k: v for k, v in res.items()})
    out.update(_port_errors(hvd))
    if n == 2:
        state = {"w": data["model.w"], "b": data["model.b"]}
        for kind, parallel in (("step", False), ("parallel", True)):
            res = _port_steps(hvd, state, data["model.batch"], parallel)
            for k, v in zip(("losses", "w", "b", "comm_calls", "responses"),
                            res):
                out[f"{kind}.{k}"] = v
        out.update(_port_outside(hvd))
        out.update(_port_inside_errors(hvd))
    np.savez(dst.format(rank=rank), **out)
    assert "jax" not in sys.modules
    hvd.shutdown()


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _ref_mesh(n, axes):
    import jax
    from jax.sharding import Mesh

    axes = axes or {"data": n}
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def _ref_case(cid, n, arrays):
    """The reference's {key: [n, ...] array} of one case, every rank's
    result stacked: ``out``, ``dtype``, ``grad`` or ``grad_error``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops import collective_ops as jcops

    case = CASES[cid]
    kw = _kwargs(case["kw"], jcops)
    mesh = _ref_mesh(n, case["mesh"])
    spec = P(tuple(mesh.axis_names))

    def run(body, *xs):
        return jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec,) * len(xs), out_specs=spec,
            check_vma=False))(*xs)

    def arr(a, dtype):
        return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)

    res = {}
    if case["fn"] == "axis":
        name = kw.get("axis_name", "data")
        res["out"] = np.asarray(run(lambda s: jnp.stack([
            jcops.axis_rank(name), jcops.axis_size(name)])[None],
            jnp.zeros((n, 1))))
        return res
    if case["fn"] == "grouped_allreduce":
        shapes = (GROUPED_SHAPES if case["dtype"] == "mixed"
                  else [(s, "float32") for s, _ in GROUPED_SHAPES])
        xs = [arr(arrays[f"x{i}"], d) for i, (_, d) in enumerate(shapes)]

        def grouped(*shards):
            return tuple(o[None] for o in jcops.grouped_allreduce(
                [s[0] for s in shards], **kw))

        prev = os.environ.get("HOROVOD_FUSION_THRESHOLD")
        os.environ["HOROVOD_FUSION_THRESHOLD"] = FUSION_BYTES
        try:
            outs = jax.jit(jax.shard_map(
                grouped, mesh=mesh, in_specs=(spec,) * len(xs),
                out_specs=(spec,) * len(xs), check_vma=False))(*xs)
            if case["grad"]:
                ws = [arr(arrays[f"w{i}"], "float32")
                      for i in range(len(xs))]

                def body(*a):
                    k = len(a) // 2

                    def loss(xs):
                        return sum(jnp.sum(o * w[0]) for o, w in zip(
                            jcops.grouped_allreduce(xs, **kw), a[k:]))
                    return tuple(g[None] for g in jax.grad(loss)(
                        [s[0] for s in a[:k]]))
                grads = jax.jit(jax.shard_map(
                    body, mesh=mesh, in_specs=(spec,) * (2 * len(xs)),
                    out_specs=(spec,) * len(xs), check_vma=False))(*xs, *ws)
                res.update({f"grad{i}": np.asarray(g)
                            for i, g in enumerate(grads)})
        finally:
            if prev is None:
                del os.environ["HOROVOD_FUSION_THRESHOLD"]
            else:
                os.environ["HOROVOD_FUSION_THRESHOLD"] = prev
        for i, o in enumerate(outs):
            res[f"out{i}"] = np.asarray(o.astype(jnp.float32))
            res[f"dtype{i}"] = str(o.dtype)
        return res
    fn = getattr(jcops, case["fn"])
    x = arr(arrays["x"], case["dtype"])
    out = run(lambda s: fn(s[0], **kw)[None], x)
    res["out"] = np.asarray(out.astype(jnp.float32))
    res["dtype"] = str(out.dtype)
    if case["grad"] is not False:
        def body(s, w):
            return jax.grad(lambda v: jnp.sum(fn(v, **kw) * w[0]))(s[0])[None]
        try:
            res["grad"] = np.asarray(run(body, x, jnp.asarray(arrays["w"])))
        except NotImplementedError as e:
            res["grad_error"] = str(e)
    return res


def _ref_steps(state, batch):
    """The reference's ``make_train_step`` on 2 devices with the same
    collectives in its loss: (losses, weight, bias)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    import horovod_tpu.jax as jhvd
    from horovod_tpu.ops.losses import softmax_cross_entropy

    def loss_fn(params, x):
        emb = x @ params["w"] + params["b"]
        every = jhvd.allgather(emb)
        labels = jnp.arange(emb.shape[0]) + lax.axis_index("data") * \
            emb.shape[0]
        xent = softmax_cross_entropy(emb @ every.T / 4.0, labels)
        return xent + 0.1 * jhvd.allreduce(jnp.mean(emb * emb))

    mesh = jhvd.data_parallel_mesh(devices=jax.devices()[:2])
    opt = jhvd.DistributedOptimizer(optax.sgd(LR))
    step = jhvd.make_train_step(loss_fn, opt, mesh, donate=False)
    params = {k: jnp.asarray(v) for k, v in state.items()}
    opt_state = opt.init(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(batch))
        losses.append(float(loss))
    return np.array(losses), np.asarray(params["w"]), np.asarray(params["b"])


def rank_world(n, *args):
    from horovod_tpu_torch.common.launch import World

    return World(n, [sys.executable, os.path.abspath(__file__), *args],
                 env=dict(PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                 drop=("HOROVOD_", "OMPI_", "PMI_", "JAX_", "XLA_"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started together, the reference computed while they
    run: {"ref": {(case, n): result}, "port": {n: [rank outputs]},
    "steps_ref": ..., "inputs": ...}."""
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(11)
    state = {"w": rng.standard_normal((D_IN, D_EMB)).astype(np.float32)
             * 0.5,
             "b": rng.standard_normal(D_EMB).astype(np.float32) * 0.1}
    batch = rng.standard_normal((2 * ROWS, D_IN)).astype(np.float32)
    inputs, worlds = {}, {}
    for n in (2, 4):
        arrays = {}
        for cid, c in CASES.items():
            if n in c["worlds"]:
                inputs[cid, n] = _inputs(cid, n)
                arrays.update({f"{cid}.{k}": v
                               for k, v in inputs[cid, n].items()})
        if n == 2:
            arrays.update({"model.w": state["w"], "model.b": state["b"],
                           "model.batch": batch})
        np.savez(tmp / f"in{n}.npz", **arrays)
        worlds[n] = rank_world(n, str(tmp / f"in{n}.npz"),
                               str(tmp / f"out{n}_{{rank}}.npz"))
    with worlds[2], worlds[4]:
        ref = {key: _ref_case(*key, inputs[key]) for key in RUNS}
        steps_ref = _ref_steps(state, batch)
        for world in worlds.values():
            world.wait(timeout_s=240)
    port = {n: [np.load(tmp / f"out{n}_{r}.npz") for r in range(n)]
            for n in (2, 4)}
    return {"ref": ref, "port": port, "steps_ref": steps_ref,
            "inputs": inputs}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


BIT_RUNS = [(c, n) for c, n in RUNS if not CASES[c]["pinned"]]


@pytest.mark.parametrize("cid,n", BIT_RUNS,
                         ids=[f"{c}-{n}" for c, n in BIT_RUNS])
def test_collective_matches_the_reference_bit_for_bit(runs, cid, n):
    ref, ranks = runs["ref"][cid, n], runs["port"][n]
    keys = sorted(k for k in ref if k.startswith("out"))
    for r, rank in enumerate(ranks):
        for k in keys:
            got = rank[f"{cid}.{k}"]
            np.testing.assert_array_equal(_bits(got), _bits(ref[k][r]),
                                          err_msg=f"{cid} rank {r} {k}")
            d = k.replace("out", "dtype")
            if d in ref:
                assert str(rank[f"{cid}.{d}"]) == ref[d], (cid, k)


GRAD_RUNS = [(c, n) for c, n in RUNS if CASES[c]["grad"] is True]


@pytest.mark.parametrize("cid,n", GRAD_RUNS,
                         ids=[f"{c}-{n}" for c, n in GRAD_RUNS])
def test_collective_gradient_matches_jax_grad(runs, cid, n):
    ref, ranks = runs["ref"][cid, n], runs["port"][n]
    keys = sorted(k for k in ref if k.startswith("grad"))
    assert keys, cid
    for r, rank in enumerate(ranks):
        for k in keys:
            np.testing.assert_allclose(rank[f"{cid}.{k}"], ref[k][r],
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"{cid} rank {r} {k}")


RAISE_RUNS = [(c, n) for c, n in RUNS if CASES[c]["grad"] == "raises"]


@pytest.mark.parametrize("cid,n", RAISE_RUNS,
                         ids=[f"{c}-{n}" for c, n in RAISE_RUNS])
def test_min_max_have_no_gradient_as_in_jax(runs, cid, n):
    ref = runs["ref"][cid, n]
    for rank in runs["port"][n]:
        assert str(rank[f"{cid}.grad_error"]) == ref["grad_error"]


def test_grouped_allreduce_spans_several_buckets(runs):
    """The mixed-dtype case ran one in-order allreduce (a reduce-scatter
    and an allgather) per bucket of the 32-byte plan."""
    from horovod_tpu_torch.ops.fusion import plan_fusion

    xs = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in GROUPED_SHAPES]
    buckets = len(plan_fusion(xs, int(FUSION_BYTES)).buckets)
    assert buckets > 2
    for n in (2, 4):
        for rank in runs["port"][n]:
            assert int(rank["grouped_mixed.calls"]) == 2 * buckets


@pytest.mark.parametrize("n", [2, 4])
def test_shape_and_dtype_checks(runs, n):
    want = {"rs_untiled_len": "ValueError", "rs_indivisible": "ValueError",
            "rs_min": "ValueError", "a2a_indivisible": "ValueError",
            "bcast_bool": "TypeError", "bcast_root": "ValueError",
            "no_axis": "ValueError"}
    for rank in runs["port"][n]:
        assert {k: str(rank[f"err.{k}"]) for k in want} == want


def test_broadcast_sends_the_roots_bits(runs):
    """Pinned (ROADMAP.md Queue C): the reference's masked psum turns the
    root's -0.0 into 0.0; the port's broadcast sends the root's bits.
    Every other bit is the reference's."""
    ref, x = runs["ref"]["broadcast_negzero", 2], \
        runs["inputs"]["broadcast_negzero", 2]["x"]
    for r, rank in enumerate(runs["port"][2]):
        got = rank["broadcast_negzero.out"]
        np.testing.assert_array_equal(_bits(got), _bits(x[1]))
        np.testing.assert_array_equal(got, ref["out"][r])
        assert np.signbit(got[0]).all() and not np.signbit(
            ref["out"][r][0]).any()


@pytest.mark.parametrize("kind", ["step", "parallel"])
def test_step_takes_the_device_plane_and_tracks_the_reference(runs, kind):
    ref_losses, ref_w, ref_b = runs["steps_ref"]
    for rank in runs["port"][2]:
        np.testing.assert_allclose(rank[f"{kind}.losses"], ref_losses,
                                   rtol=STEP_RTOL)
        np.testing.assert_allclose(rank[f"{kind}.w"], ref_w, rtol=STEP_RTOL,
                                   atol=STEP_RTOL)
        np.testing.assert_allclose(rank[f"{kind}.b"], ref_b, rtol=STEP_RTOL,
                                   atol=STEP_RTOL)
        assert int(rank[f"{kind}.comm_calls"]) > 0
        assert int(rank[f"{kind}.responses"]) == 0
    assert ref_losses[-1] < ref_losses[0]


def test_outside_a_step_the_engine_runs_as_before(runs):
    for rank in runs["port"][2]:
        for k in ("allreduce", "epoch_loss", "grouped", "allgather",
                  "broadcast", "reducescatter", "alltoall", "keras"):
            assert bool(rank[f"outside.{k}"]), k
        assert int(rank["outside.responses"]) >= 16
        assert int(rank["outside.comm_calls"]) == 0


def test_splits_inside_a_step_raise_the_references_error(runs):
    for rank in runs["port"][2]:
        assert str(rank["inside.splits"]).startswith(
            "variable splits are eager-only")


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])

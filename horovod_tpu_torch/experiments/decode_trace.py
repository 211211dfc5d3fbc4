"""Where the paged decode's time goes on the card.

    python -m horovod_tpu_torch.experiments.decode_trace

Builds ``csrc/paged_attention.cu`` as it is and three copies of it with
nvcc into ``horovod_tpu_torch/_build/``: one with a ``%globaltimer``
stamp at each phase of a CTA, and ones whose ranges are 64 and 256
slots.  At ``chip_smoke.py``'s timed decode shape (bf16, B 8, Hq 32,
Hkv 8, D 128, block 16, table width 128, pos [2047, 1087, 600, 320, 100,
0, 16, 0], row 7 padded) it prints one JSON line per build: its error
against the plain version, and the median of 50 CUDA-graph replays with
the L2 dirtied before each (256 MiB written: ``chip_smoke.py``'s
convention), clean (256 MiB read) or warm (nothing).  The stamped build
adds each live CTA's phases in microseconds (min, median, max): entry to
pos read (``pos``), to the first chunk in (``first_chunk``), the scores
(``scores``, to the softmax), PV (``pv``), the fence and the counter
(``count``), and the merge (``merge``, rows with more than one range).
Needs one GPU.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import paged_attention as pa

POS = [2047, 1087, 600, 320, 100, 0, 16, 0]
_CTA = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
#: (anchor line of the source, the stamp that follows it; a negative
#: slot goes before the anchor).
_STAMPS = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n", 0),
    ("  if (t_begin >= n) return;   // no live token in this range\n", 1),
    ("    issue(i + kStages - 1);   // into the stage chunk i - 1 held\n", 2),
    ("  T* ob = out + (static_cast<size_t>(b) * Hq + "
     "static_cast<size_t>(h) * G) * D;\n", -4),
    ("  if (!last) return;\n", -5),
    ("      if (i < G * D) ob[i] = from_f32<T>(num[k] / l_s[i / D]);\n"
     "    }\n  }\n", 6),
]
_PHASES = ["pos", "first_chunk", "scores", "pv", "count", "merge"]


def _stamped(src: str) -> str:
    """The source with thread 0 of each CTA writing globaltimer at each
    phase into g_t[CTA][slot] (0 before the first stamp of a live CTA),
    and ``dbg_times`` to copy them out."""
    head = ("__device__ unsigned long long g_t[8192][8];\n"
            "__device__ __forceinline__ unsigned long long gtime() {\n"
            "  unsigned long long t;\n"
            '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
            "  return t;\n}\n")
    src = src.replace("namespace {\n", "namespace {\n" + head, 1)
    for anchor, slot in _STAMPS:
        assert src.count(anchor) == 1, anchor
        if slot == 0:
            stamp = (f"  if (tid == 0) {{ g_t[{_CTA}][0] = gtime();\n"
                     f"    for (int s = 1; s < 8; ++s) g_t[{_CTA}][s] = 0;"
                     " }\n")
        elif slot == 2:   # the first chunk in, and the softmax's start
            stamp = (f"    if (tid == 0 && i == 0) g_t[{_CTA}][2] = gtime();"
                     f"\n    if (tid == 0 && i == nk) g_t[{_CTA}][3] = "
                     "gtime();\n")
        else:
            stamp = f"  if (tid == 0) g_t[{_CTA}][{abs(slot)}] = gtime();\n"
        src = src.replace(anchor, anchor + stamp if slot >= 0
                          else stamp + anchor)
    return src + ('\nextern "C" int dbg_times(void* dst, int n) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                  "      dst, g_t, n * 8 * sizeof(unsigned long long)));\n}\n")


def build_variants():
    """name -> loaded library of each build, compiled in parallel."""
    src = _build.sources()["paged_attention"].read_text()
    rng = "constexpr int kRange = 128;"
    assert src.count(rng) == 1
    texts = {"as_is": src, "stamped": _stamped(src),
             "range64": src.replace(rng, "constexpr int kRange = 64;"),
             "range256": src.replace(rng, "constexpr int kRange = 256;")}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = _build.BUILD_DIR / f"decode_trace_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"decode_trace: {name} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def timed_case(dev, seed=0):
    """(q, pool_k, pool_v, tables, pos) at the timed shape: distinct random
    live blocks per row, the trash block past pos, row 7 all trash."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb, BS, maxb = 513, 16, 128
    q = torch.randn((8, 1, 32, 128), generator=gen, device=dev).bfloat16()
    pk = torch.randn((nb, BS, 8, 128), generator=gen, device=dev).bfloat16()
    pv = torch.randn((nb, BS, 8, 128), generator=gen, device=dev).bfloat16()
    tables = np.zeros((8, maxb), np.int32)
    for i, p in enumerate(POS[:7]):
        tables[i, :p // BS + 1] = rng.permutation(np.arange(1, nb))[
            :p // BS + 1]
    return (q, pk, pv, torch.from_numpy(tables).to(dev),
            torch.tensor(POS, dtype=torch.int32, device=dev))


def caller(lib, args):
    """A no-argument call of ``lib``'s decode on ``args`` with its own
    output and scratch (as ``paged_attention_decode`` allocates them)."""
    q, pk, pv, tables, pos = args
    fn = lib.hvd_paged_attention_decode
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    B, _, Hq, D = q.shape
    BS, Hkv = pk.shape[1], pk.shape[2]
    G = Hq // Hkv
    splits = -(-tables.shape[1] * BS // lib.hvd_paged_attention_range_tokens())
    out = torch.empty_like(q)
    ml = torch.empty((B, Hkv, splits, G, 2), device=q.device)
    acc = torch.empty((B, Hkv, splits, G, D), device=q.device)
    cnt = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)

    def run():
        err = fn(*[t.data_ptr() for t in (q, pk, pv, tables, pos, out, ml,
                                           acc, cnt)],
                 B, Hkv, G, D, BS, tables.shape[1], 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode_trace: launch failed ({err})")
        return out
    return run, splits


def graph_ms(run, flush, mode):
    """Median ms of 50 replays of a CUDA graph of ``run``; before each the
    L2 is dirtied (``flush.zero_()``), cleaned (a read of ``flush``) or
    left warm."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    pairs = []
    for _ in range(50):
        if mode == "dirty":
            flush.zero_()
        elif mode == "clean":
            flush.view(torch.int64).sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phases(lib, run, flush, n_ctas):
    """Each live CTA's phases (µs: min, median, max) of one call after a
    dirty flush, from the stamped build."""
    flush.zero_()
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    buf = np.zeros((n_ctas, 8), np.uint64)
    if lib.dbg_times(buf.ctypes.data_as(ctypes.c_void_p), n_ctas):
        raise RuntimeError("decode_trace: could not read the stamps")
    t = buf.astype(np.int64)
    live = t[:, 1] > 0
    t0 = t[:, 0].min()

    def spread(x):
        return [round(float(v), 3) for v in np.percentile(x, [0, 50, 100])]

    out = {"span_us": round(float(t[t > 0].max() - t0) / 1e3, 3),
           "live_ctas": int(live.sum()),
           "start_us": spread((t[live, 0] - t0) / 1e3)}
    for k, name in enumerate(_PHASES, start=1):
        have = live & (t[:, k] > 0) & (t[:, k - 1] > 0)
        if have.any():
            out[name + "_us"] = spread((t[have, k] - t[have, k - 1]) / 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_trace: needs a CUDA device")
    dev = torch.device("cuda")
    libs = build_variants()
    args = timed_case(dev)
    ref = pa._decode_blockwise(*args).float()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for name, lib in libs.items():
        run, splits = caller(lib, args)
        err = float((run().float() - ref).abs().max())
        line = {"build": name,
                "range_tokens": lib.hvd_paged_attention_range_tokens(),
                "max_abs_err": err,
                "ms": {m: graph_ms(run, flush, m)
                       for m in ("dirty", "clean", "warm")}}
        if name == "stamped":
            line.update(phases(lib, run, flush, 8 * 8 * splits))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

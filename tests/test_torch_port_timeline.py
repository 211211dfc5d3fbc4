"""Port parity: the engine's timeline on the port, merged across ranks.

The port's engine (``horovod_tpu_torch/cpp/timeline.cc``) writes one
Chrome trace a rank under ``HOROVOD_TIMELINE`` and
``HOROVOD_TIMELINE_ALL_RANKS=1``; ``horovod_tpu_torch/timeline.py``
merges them onto rank 0's clock.  The counterparts of
``tests/test_observability.py``'s timeline tests, on engine worlds of the
port on CPU tensors (``torch_port_obs_worker.py``):

* a 2-rank merged trace: every flow resolves (``nsink == 2 nsrc``), no
  event before 0, every sink after its source; the JAX package's
  ``load_trace``/``merge_traces``/``check_flows``, run on the port's
  files, give what the port's do; the merge CLI writes one valid trace;
* the hook-form ``DistributedOptimizer``'s gradient names are the
  engine's spans, and the ranks' parameters agree;
* rotation under ``HOROVOD_TIMELINE_MAX_MB`` keeps the newest events in
  the configured path and leaves valid JSON behind.
"""

import json
import os
import subprocess
import sys

from horovod_tpu import timeline as jax_timeline
from horovod_tpu_torch import timeline
from tests.torch_port_obs_worker import REPO, TELEM_ENV, parse, run_world


def _trace_names(events):
    return {str(e.get("args", {}).get("name", "")) for e in events} | \
        {str(e.get("name", "")) for e in events}


def test_merged_timeline_flows_resolve_like_the_reference(tmp_path):
    tl = tmp_path / "tl.json"
    run_world(2, "timeline_workload", dict(
        TELEM_ENV, HOROVOD_TIMELINE=str(tl),
        HOROVOD_TIMELINE_ALL_RANKS="1"), timeout=120)
    files = [str(tl), str(tl) + ".rank1"]
    assert all(os.path.exists(f) for f in files)
    for f in files:
        assert timeline.load_trace(f) == jax_timeline.load_trace(f)
    merged = timeline.merge_traces(files)
    assert merged == jax_timeline.merge_traces(files)
    nsrc, nsink, unresolved = timeline.check_flows(merged)
    assert (nsrc, nsink, unresolved) == jax_timeline.check_flows(merged)
    assert nsrc > 0 and nsink == 2 * nsrc and unresolved == []
    assert all(e.get("ts", 0) >= 0 for e in merged)
    sources = {e["id"]: e["ts"] for e in merged if e.get("ph") == "s"}
    for e in merged:
        if e.get("ph") == "f":
            assert e["ts"] >= sources[e["id"]], e["id"]
    names = _trace_names(merged)
    for want in ("tlw.t0", "tlw.bcast", "tlw.gather"):
        assert any(want in n for n in names), want
    out = tmp_path / "merged.json"
    cli = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.timeline", "merge",
         str(tl) + "*", "-o", str(out)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=60)
    assert cli.returncode == 0, cli.stderr
    assert f"merged 2 trace(s), {len(merged)} events" in cli.stdout
    events = json.loads(out.read_text())
    assert events == merged
    procs = {e.get("args", {}).get("name", "") for e in events
             if e.get("name") == "process_name"}
    assert any(n.startswith("r0/") for n in procs)
    assert any(n.startswith("r1/") for n in procs)


def test_hook_form_gradients_are_the_timelines_spans(tmp_path):
    tl = tmp_path / "tl.json"
    results = run_world(2, "timeline_hook", dict(
        TELEM_ENV, HOROVOD_TIMELINE=str(tl),
        HOROVOD_TIMELINE_ALL_RANKS="1"), timeout=120)
    recs = {r["rank"]: r for r in parse(results, "OBS_HOOK")}
    assert recs[0]["params"] == recs[1]["params"]
    merged = timeline.merge_traces([str(tl), str(tl) + ".rank1"])
    nsrc, nsink, unresolved = timeline.check_flows(merged)
    assert nsrc > 0 and nsink == 2 * nsrc and unresolved == []
    names = _trace_names(merged)
    for grad in recs[0]["names"]:
        assert any(grad in n for n in names), grad


def test_timeline_rotation_keeps_the_newest_and_valid_json(tmp_path):
    tl = tmp_path / "tl.json"
    run_world(1, "rotate", {"HOROVOD_TIMELINE": str(tl),
                            "HOROVOD_TIMELINE_MAX_MB": "1"}, timeout=180)
    old = tmp_path / "tl.json.old"
    assert old.exists(), "no rotation happened"
    json.loads(old.read_text())
    newest = timeline.load_trace(str(tl))
    assert newest == jax_timeline.load_trace(str(tl))
    assert any("rotate.final.marker" in n for n in _trace_names(newest))
    assert any(e.get("name") == "horovod_meta" for e in newest)

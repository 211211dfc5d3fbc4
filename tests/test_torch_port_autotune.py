"""Port parity: the autotuning plane (``horovod_tpu_torch/autotune/``) and
the knob table behind ``run --print-config``.

* The seeded search: ``CoordinateSearch.planned_schedule()`` and its
  winners equal the JAX package's for several seeds and spaces
  (``default_space`` under the knob-restricting and wire variables too).
* State files written by either package load in the other, and the
  wiring warm start sets the same env.
* ``resolved_config``/``format_table`` equal the reference's for the
  defaults, every knob set, and a state file present, but for the rows
  listed in ``PORT_ROWS_DIFFER`` with their reasons.
* Engine worlds of the port on CPU tensors (``torch_port_obs_worker.py``),
  the counterparts of ``tests/test_autotune.py``: with autotuning off no
  tuner and no TUNE frame; at 2 ranks a live search runs the planned
  schedule (the reference's for the same space and seed), commits, and
  every rank holds the committed knobs, its ``TUNE_TRIAL(``/
  ``TUNE_COMMIT(`` markers in the timeline; a warm start from the state
  file runs no trial; a re-init under a new epoch re-commits without a
  search; the wire sweep runs only under ``HOROVOD_AUTOTUNE_WIRE=1``;
  ``startup_probe`` re-wires every rank with rank 0's pick.
  Rank 0 ends each live loop once its tuner has committed, so no check
  counts on a particular TUNE frame's timing.
"""

import os

import pytest

from horovod_tpu.autotune import config as jax_config
from horovod_tpu.autotune import search as jax_search
from horovod_tpu.autotune import store as jax_store
from horovod_tpu.autotune import tuner as jax_tuner
from horovod_tpu_torch.autotune import config, search, store, tuner
from tests.torch_port_obs_worker import parse, run_world

#: Rows where the port's knob table differs from the reference's, and
#: why: the three knobs whose help names a command give the port's
#: command (``python -m horovod_tpu_torch.<tool>``), and
#: ``HOROVOD_PAGED_ATTN_CHUNK`` tunes the port's plain CPU decode where
#: it tunes the JAX package's XLA stand-in (its help names what it tunes).
PORT_ROWS_DIFFER = {"HOROVOD_METRICS_PORT": "command",
                    "HOROVOD_FLIGHT_RECORDER_DIR": "command",
                    "HOROVOD_TIMELINE_ALL_RANKS": "command",
                    "HOROVOD_PAGED_ATTN_CHUNK": "plain"}
#: The words of the chunk knob's help that name what it tunes.
CHUNK_DOC = (("blockwise XLA fused-attention path (off-TPU stand-in for "
              "the Pallas kernel); 1 = the kernel's exact per-block "
              "reduction order"),
             ("fused decode's plain CPU version (off-card stand-in for the "
              "CUDA kernel); 1 = the per-block walk"))

#: Small fixed-bytes windows: the loop moves 1 MiB a step, so a trial
#: scores over ~2 steps.
TUNE_ENV = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_SEED": "7",
            "HOROVOD_AUTOTUNE_WINDOW_BYTES": str(2 << 20),
            "HOROVOD_AUTOTUNE_TRIAL_TIMEOUT_SEC": "20",
            "HOROVOD_AUTOTUNE_KNOBS":
            "chunk_bytes,fusion_threshold,cycle_time_ms"}


# ---------------------------------------------------------------------------
# the search, the state file and the knob table against the reference's
# ---------------------------------------------------------------------------

_SPACE_ENVS = {"all": {}, "knobs": {"HOROVOD_AUTOTUNE_KNOBS":
                                    "chunk_bytes,wave_width"},
               "wire": {"HOROVOD_AUTOTUNE_WIRE": "1"},
               "ladder": {"HOROVOD_AUTOTUNE_LADDER_BANDS": "3"}}


@pytest.mark.parametrize("space_env", sorted(_SPACE_ENVS))
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_planned_schedule_and_winners_match_the_reference(
        monkeypatch, space_env, seed):
    for k in ("HOROVOD_AUTOTUNE_KNOBS", "HOROVOD_AUTOTUNE_WIRE",
              "HOROVOD_AUTOTUNE_LADDER_BANDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in _SPACE_ENVS[space_env].items():
        monkeypatch.setenv(k, v)
    for channels, bands in ((1, 0), (4, 0), (4, 2)):
        space = tuner.default_space(channels, bands)
        assert space == jax_tuner.default_space(channels, bands)
        for cap in (None, 5):
            got = search.CoordinateSearch(space, seed=seed, max_trials=cap)
            want = jax_search.CoordinateSearch(space, seed=seed,
                                               max_trials=cap)
            assert got.planned_schedule() == want.planned_schedule()
            # The same scores (one discarded) pick the same winners.
            i = 0
            while (cfg := got.propose()) is not None:
                assert cfg == want.propose()
                score = None if i == 2 else float((i * 7919) % 13)
                got.observe(score)
                want.observe(score)
                i += 1
            assert want.propose() is None and got.converged
            assert (got.best, got.best_score, got.trials) == \
                (want.best, want.best_score, want.trials)
    assert search.ladder(3, 40) == jax_search.ladder(3, 40) == \
        [3, 6, 12, 24, 40]


def test_state_files_load_in_either_package(tmp_path):
    committed = {"chunk_bytes": 1 << 20, "cycle_time_ms": 2,
                 "fusion_threshold": 32 << 20, "wave_width": 2,
                 "algo_threshold": 0, "fusion_ladder_1": 4 << 20,
                 "wire_dtype": 0}
    wiring = {"num_channels": 2, "channel_drivers": 3}
    for writer, reader in ((store, jax_store), (jax_store, store)):
        path = str(tmp_path / f"{writer.__name__}.json")
        writer.save_state(path, committed, 12.5, seed=7, wiring=wiring)
        assert reader.load_state(path) == writer.load_state(path)
        assert reader.load_state(path)["committed"] == committed
        env_a, env_b = ({"HOROVOD_AUTOTUNE_STATE_FILE": path,
                         "HOROVOD_CHANNEL_DRIVERS": "5"} for _ in range(2))
        assert store.apply_wiring_warm_start(env_a) == \
            jax_store.apply_wiring_warm_start(env_b)
        assert env_a == env_b and env_a["HOROVOD_NUM_CHANNELS"] == "2"
        assert env_a["HOROVOD_CHANNEL_DRIVERS"] == "5"    # the user's wins
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert store.load_state(str(bad)) is None


def _every_knob_set():
    env = {}
    for knob in jax_config.KNOBS:
        env[knob.env] = {"HOROVOD_WIRE_DTYPE": "int8",
                         "HOROVOD_BACKUP_WORKERS": "auto",
                         "HOROVOD_BACKUP_AUTO_RULE": "steptime",
                         "HOROVOD_FUSION_LADDER": "1024,2048",
                         "HOROVOD_HOST_KEY": "hostA",
                         "HOROVOD_WIRE_POLICY_RATIO": "32.0",
                         "HOROVOD_BACKUP_AUTO_RATIO": "2.5",
                         "HOROVOD_MOE_CAPACITY_FACTOR": "2.0",
                         "HOROVOD_SPARSE_TOPK": "0.05",
                         "HOROVOD_CONTROL_PATIENCE_SEC": "300",
                         "HOROVOD_METRICS_PORT": "9100",
                         "HOROVOD_FLIGHT_RECORDER_DIR": "/tmp/fr",
                         "HOROVOD_CHECKPOINT_DIR": "/tmp/ck",
                         "HOROVOD_AUTOTUNE_STATE_FILE": "/tmp/at.json",
                         }.get(knob.env, "3")
    env.update(HOROVOD_SERVE_MAX_BATCH="6", HOROVOD_SERVE_BLOCK_SIZE="8",
               HOROVOD_SERVE_AUTOTUNE="1", HOROVOD_SERVE_PROBE_SEC="2",
               HOROVOD_PAGED_ATTN_CHUNK="4")
    return env


def _expected_rows(ref_rows):
    out = []
    for row in ref_rows:
        kind = PORT_ROWS_DIFFER.get(row["env"])
        if kind == "command":
            row = dict(row, doc=row["doc"].replace("horovod_tpu.",
                                                   "horovod_tpu_torch."))
        if kind == "plain":
            row = dict(row, doc=row["doc"].replace(*CHUNK_DOC))
        out.append(row)
    return out


@pytest.mark.parametrize("which", ["defaults", "every_knob", "state_file"])
def test_knob_table_matches_the_reference(tmp_path, which):
    if which == "defaults":
        env = {}
    elif which == "every_knob":
        env = _every_knob_set()
    else:
        path = str(tmp_path / "state.json")
        store.save_state(path, {"chunk_bytes": 1 << 16}, 1.0, seed=3,
                         wiring={"num_channels": 2})
        env = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_STATE_FILE": path}
        store.apply_wiring_warm_start(env)
        assert env["HOROVOD_NUM_CHANNELS"] == "2"
    got = config.resolved_config(env)
    assert got == _expected_rows(jax_config.resolved_config(env))
    assert len(got) == len(jax_config.resolved_config(env))
    table = config.format_table(env).splitlines()
    ref = jax_config.format_table(env).splitlines()
    assert len(table) == len(ref)
    for line in ref:
        knob = line.split(" ", 1)[0]
        kind = PORT_ROWS_DIFFER.get(knob)
        if kind == "command":
            line = line.replace("horovod_tpu.", "horovod_tpu_torch.")
        if kind == "plain":
            line = line.replace(*CHUNK_DOC)
        assert line in table, line


# ---------------------------------------------------------------------------
# engine worlds
# ---------------------------------------------------------------------------

def test_autotune_off_starts_nothing_and_changes_nothing():
    recs = parse(run_world(2, "autotune_disabled", timeout=120), "AT_OFF")
    for r in recs:
        assert r["tune_trials"] == 0
        cfg = r["config"]
        assert cfg["chunk_bytes"] == 1 << 20
        assert cfg["fusion_threshold"] == 64 << 20
        assert cfg["cycle_time_ms"] == 2
        assert cfg["wave_width"] == cfg["num_channels"]


def _reference_plan(monkeypatch, rec):
    for k, v in TUNE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HOROVOD_AUTOTUNE_WIRE", raising=False)
    space = jax_tuner.default_space(rec["num_channels"],
                                    rec["priority_bands"])
    return [list(p) for p in jax_search.CoordinateSearch(
        space, seed=int(TUNE_ENV["HOROVOD_AUTOTUNE_SEED"]),
        max_trials=32).planned_schedule()]


def test_live_search_commits_on_every_rank_then_warm_starts(
        monkeypatch, tmp_path):
    """The live search (timeline on), then fresh processes against its
    state file: no trial, the committed knobs and wiring in force."""
    tl, state = tmp_path / "tl.json", tmp_path / "state.json"
    env = dict(TUNE_ENV, HOROVOD_AUTOTUNE_STATE_FILE=str(state))
    recs = parse(run_world(2, "autotune_live", dict(
        env, HOROVOD_TIMELINE=str(tl)), timeout=240), "AT_LIVE")
    r0 = recs[0]
    assert r0["converged"] and r0["committed"] is not None
    assert r0["planned"] == _reference_plan(monkeypatch, r0)
    assert len(r0["executed"]) == len(r0["planned"])
    for (knob, value), cfg in zip(r0["planned"], r0["executed"]):
        assert cfg[knob] == value, (knob, value, cfg)
    assert any(s is not None for s in r0["scores"])
    for r in recs:
        assert r["tune_trials"] >= 1
        for key, (have, want) in r["config_vs_committed"].items():
            assert have == want, (r["rank"], key, have, want)
    text = tl.read_text()
    assert "TUNE_TRIAL(chunk=" in text and "TUNE_COMMIT(" in text
    assert store.load_state(str(state))["committed"] == r0["committed"]

    warm = parse(run_world(2, "autotune_warm_restart", env, timeout=120),
                 "AT_WARM")
    assert warm[0]["trace"] == []
    for r in warm:
        assert r["applied"], r
        assert r["num_channels"] == r["state"]["wiring"]["num_channels"]


def test_reinit_under_a_new_epoch_recommits_without_a_search():
    recs = {r["rank"]: r for r in parse(
        run_world(2, "autotune_epoch", TUNE_ENV, timeout=300), "AT_EPOCH")}
    r0 = recs[0]
    assert r0["committed"][0] == r0["committed"][1]
    assert r0["trials"] > 0 and r0["trace_after"] == []
    for r in recs.values():
        assert r["epoch"][1] > r["epoch"][0]
        assert r["tune_trials"][1] > r["tune_trials"][0]
        assert r["stale_epoch_msgs"] == 0
    assert r0["tuner_epoch"] == r0["epoch"][1]


def test_startup_probe_rewires_every_rank_alike():
    """``startup_probe`` at 2 ranks on CPU tensors: each candidate wiring
    is measured through a re-init, rank 0's pick reaches every rank and
    its env, and the re-wired world (same device) reduces right."""
    recs = parse(run_world(2, "startup_probe", timeout=180), "AT_PROBE")
    picks = {tuple(sorted(r["pick"].items())) for r in recs}
    assert len(picks) == 1
    for r in recs:
        ch = r["pick"]["num_channels"]
        assert (ch, r["pick"]["channel_drivers"]) in ((1, 0), (2, 1))
        assert r["env"][0] == str(ch) and r["num_channels"] == ch
        assert r["ok"] and r["device"] == "cpu" and r["suspend"] is None


@pytest.mark.parametrize("wire", ["0", "1"])
def test_the_wire_knob_is_swept_only_when_asked(monkeypatch, wire):
    """Under ``HOROVOD_AUTOTUNE_WIRE=1`` with the sweep cut to
    ``wire_dtype``, fp32, fp16 and int8 are tried, one is committed, and
    compressed responses ran; without it the wire never joins the space
    (the search runs the same knob list without ``wire_dtype``)."""
    for k in ("HOROVOD_AUTOTUNE_KNOBS", "HOROVOD_AUTOTUNE_WIRE"):
        monkeypatch.delenv(k, raising=False)
    if wire == "0":
        monkeypatch.setenv("HOROVOD_AUTOTUNE_KNOBS", "chunk_bytes")
        assert "wire_dtype" not in tuner.default_space(4)
        assert "wire_dtype" not in jax_tuner.default_space(4)
        monkeypatch.delenv("HOROVOD_AUTOTUNE_KNOBS")
        assert "wire_dtype" not in tuner.default_space(4)
        return
    recs = parse(run_world(2, "autotune_wire", dict(
        TUNE_ENV, HOROVOD_AUTOTUNE_WIRE="1",
        HOROVOD_AUTOTUNE_KNOBS="wire_dtype"), timeout=240), "AT_WIRE")
    r0 = recs[0]
    assert r0["converged"]
    assert {c["wire_dtype"] for c in r0["executed"]} == {0, 1, 3}
    assert any(s is not None for s in r0["scores"])
    assert "wire_dtype" in r0["committed"]
    assert all(r["compressed"] >= 2 for r in recs)

"""The port's lifecycle tracer and its exporters against the reference's.

Unit level, on the port: tests/test_telemetry.py's ``TestValidateTrace``
(synthetic good and bad event sequences) and ``TestExporters`` (Chrome
and JSONL round trips, the tracer's cap), and the ``validate`` command
line; the port's ``validate_trace`` gives the reference's problems on
Hypothesis-drawn lifecycles and their corruptions.

Engine level, TINY (f32), parameters carried over by ``bridge``: a
traced SLO serve under preemption, swap and resume pressure, chunked and
blocking.  Its tokens equal the untraced serve's; its trace validates
with the totals reconciled against ``last_stats``; and its event
sequence ``(name, pid, tid, uid)``, with every argument that does not
measure time, equals the reference ``Server``'s trace of the same serve.
Each reference serve runs once a module (``_Runs``)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_ref import ref_init_params
from repro.core import kv_compress
from repro.core.request_cluster import Request
from repro.models.config import ModelConfig
from repro.runtime import telemetry as tele_ref
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.scheduler import SLOConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import kv_pool as kv_pool_t
from repro_torch.runtime import scheduler as sched_t
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT
from repro_torch.runtime import telemetry as tele_t
from repro_torch.runtime.telemetry import (TRACE_SCHEMA, TelemetryConfig,
                                           Tracer, events_from_chrome,
                                           phase_breakdown,
                                           validate_chrome_file,
                                           validate_jsonl_file,
                                           validate_trace,
                                           write_chrome_trace, write_jsonl)

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY, TINY_T = ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)
CCFG = kv_compress.KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
                                    refresh_every=8)
# event arguments that measure time (the rest must equal the reference's)
TIMING_ARGS = ("ttft_ms",)


# ---------------------------------------------------------------------------
# unit: the trace validator on synthetic sequences
# ---------------------------------------------------------------------------


def _ev(name, ts, uid=None, tid="engine", pid=0, **args):
    return {"name": name, "ph": "i", "ts": float(ts), "pid": pid,
            "tid": tid, "uid": uid, "args": args}


def _sp(name, ts, dur, uid=None, tid="engine", pid=0, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": pid, "tid": tid, "uid": uid, "args": args}


def _good():
    return [
        _ev("queued", 0.0, uid=1, tid="queue"),
        _ev("queued", 1.0, uid=2, tid="queue"),
        _sp("engine_step", 10.0, 5.0, kind="mixed"),
        _ev("first_token", 15.0, uid=1, tid="slot0"),
        _sp("swap_out", 20.0, 2.0, uid=1, tid="slot0"),
        _sp("run", 5.0, 22.0, uid=1, tid="slot0", tokens=3),
        _sp("resume", 30.0, 2.0, uid=1, tid="slot0"),
        _ev("finish", 40.0, uid=1, tid="slot0"),
        _sp("run", 30.0, 10.0, uid=1, tid="slot0", tokens=4),
        _ev("shed", 41.0, uid=2, tid="queue"),
    ]


def test_clean_sequence_validates():
    assert validate_trace(_good()) == []


def test_missing_terminal_flagged():
    evs = [e for e in _good()
           if not (e["name"] == "finish" and e["uid"] == 1)]
    assert any("uid 1" in p and "terminal" in p for p in validate_trace(evs))


def test_double_terminal_flagged():
    evs = _good() + [_ev("finish", 50.0, uid=1, tid="slot0")]
    assert any("uid 1: 2 terminal" in p for p in validate_trace(evs))


def test_partial_overlap_flagged():
    evs = [_sp("engine_step", 0.0, 10.0), _sp("compact", 5.0, 10.0)]
    assert any("partially overlaps" in p for p in validate_trace(evs))
    assert validate_trace([_sp("engine_step", 0.0, 10.0),
                           _sp("compact", 2.0, 3.0),
                           _sp("engine_step", 20.0, 5.0)]) == []


def test_swap_pairing():
    bad = [_sp("resume", 5.0, 1.0, uid=3, tid="slot0")]
    assert any("resume without matching swap_out" in p
               for p in validate_trace(bad))
    parked = [_sp("swap_out", 1.0, 1.0, uid=3, tid="slot0")]
    assert any("still parked" in p for p in validate_trace(parked))
    assert validate_trace(parked + [_ev("shed", 9.0, uid=3)]) == []


def test_totals_reconciliation():
    totals = {"sched_swaps_out": 1.0, "sched_swaps_in": 1.0,
              "sched_sheds": 1.0, "decode_steps": 1.0, "gen_tokens": 7.0}
    assert validate_trace(_good(), totals=totals) == []
    assert any("gen_tokens" in p for p in validate_trace(
        _good(), totals={**totals, "gen_tokens": 99.0}))
    assert any("decode_steps" in p for p in validate_trace(
        _good(), totals={**totals, "decode_steps": 2.0}))


def test_phase_breakdown():
    ph = phase_breakdown([
        _sp("engine_step", 0.0, 1000.0, kind="decode"),
        _sp("engine_step", 2000.0, 3000.0, kind="mixed"),
        _sp("compact", 6000.0, 500.0)])
    assert ph == {"phase_compact_ms": 0.5, "phase_decode_ms": 1.0,
                  "phase_mixed_ms": 3.0}


def _lifecycles(plan):
    """tests/test_properties.py's ``TestTraceSchemaProperties._build``: a
    lifecycle event list from ``plan`` (per uid: tokens per segment and
    its terminal shape), with a monotone clock, and its totals."""
    events, clock = [], [0.0]
    totals = {"sched_swaps_out": 0.0, "sched_swaps_in": 0.0,
              "sched_sheds": 0.0, "gen_tokens": 0.0}

    def tick():
        clock[0] += 1.0
        return clock[0]

    for uid, (segs, end) in enumerate(plan):
        tid = f"slot{uid}"
        events.append(_ev("queued", tick(), uid, "queue"))
        for si, toks in enumerate(segs):
            last = si == len(segs) - 1
            t0 = tick()
            if si > 0:
                events.append(_sp("resume", t0, 0.25, uid, tid))
                totals["sched_swaps_in"] += 1
            t1 = tick()
            totals["gen_tokens"] += toks
            if not last or end == "park_shed":
                events.append(_sp("swap_out", t1, 0.25, uid, tid))
                events.append(_sp("run", t0, t1 + 0.25 - t0, uid, tid,
                                  tokens=toks))
                totals["sched_swaps_out"] += 1
            else:
                events.append(_sp("run", t0, t1 - t0, uid, tid,
                                  tokens=toks))
                events.append(_ev("shed" if end == "shed" else "finish",
                                  t1, uid, tid))
                totals["sched_sheds"] += end == "shed"
        if end == "park_shed":
            events.append(_ev("shed", tick(), uid, "engine"))
            totals["sched_sheds"] += 1
    return events, totals


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.lists(st.integers(0, 5), min_size=1,
                                   max_size=3),
                          st.sampled_from(("finish", "shed", "park_shed"))),
                min_size=1, max_size=5),
       st.integers(0, 3))
def test_validator_equals_reference_on_lifecycles(plan, corrupt):
    """Well-formed lifecycles validate clean in the port, and a corrupted
    one (a dropped terminal, a duplicated one, an orphan resume, a token
    total off by one) gets the reference's problems, word for word."""
    events, totals = _lifecycles(plan)
    assert validate_trace(events, totals=totals) == []
    if corrupt == 0:
        events = [e for e in events
                  if not (e["uid"] == 0 and e["name"] in ("finish", "shed"))]
    elif corrupt == 1:
        events = events + [_ev("finish", 1e9, uid=0, tid="slot0")]
    elif corrupt == 2:
        events = events + [_sp("resume", 2e9, 1.0, uid=999, tid="slot0")]
    else:
        totals = dict(totals, gen_tokens=totals["gen_tokens"] + 1)
    got = validate_trace(events, totals=totals)
    assert got and got == tele_ref.validate_trace(events, totals=totals)


# ---------------------------------------------------------------------------
# unit: exporters and the command line
# ---------------------------------------------------------------------------


def test_chrome_roundtrip(tmp_path):
    tr = Tracer()
    tr.begin_serve(100.0, n_shards=2)
    tr.event("queued", tid="queue", uid=4, t=100.0, queue_pos=0)
    tr.span("run", 100.0, 100.5, pid=1, tid="slot3", uid=4, tokens=5)
    tr.event("finish", 100.5, uid=4, tid="slot3", t=100.5)
    evs = tr.finish()
    path = str(tmp_path / "trace.json")
    write_chrome_trace(evs, path, n_shards=2, stats={"gen_tokens": 5.0})
    obj = json.load(open(path))
    assert obj["otherData"]["schema"] == TRACE_SCHEMA
    meta = {(e["pid"], e["name"]) for e in obj["traceEvents"]
            if e["ph"] == "M"}
    assert (1, "process_name") in meta and (1, "thread_name") in meta
    back = events_from_chrome(obj)
    assert [(e["name"], e["tid"], e["uid"]) for e in back] == \
        [("queued", "queue", 4), ("run", "slot3", 4), ("finish", "slot3", 4)]
    assert back[1]["args"]["tokens"] == 5
    assert validate_chrome_file(path) == []
    # the reference reads the port's file the same way
    assert tele_ref.events_from_chrome(obj) == back


def test_jsonl_roundtrip(tmp_path):
    tr = Tracer()
    tr.begin_serve(0.0)
    tr.span("run", 0.0, 1.0, uid=1, tid="slot0", tokens=2)
    tr.event("finish", t=1.0, uid=1, tid="slot0")
    path = str(tmp_path / "trace.jsonl")
    write_jsonl(tr.finish(), path, meta={"last_stats": {"gen_tokens": 2.0}})
    assert validate_jsonl_file(path) == []
    bad = str(tmp_path / "bad.jsonl")
    write_jsonl([_sp("run", 0.0, 1.0, uid=9, tid="slot0")], bad)
    assert validate_jsonl_file(bad) != []


def test_tracer_cap_counts_dropped():
    tr = Tracer(max_events=2)
    tr.begin_serve(0.0)
    for i in range(5):
        tr.event("queued", uid=i, t=float(i))
    assert len(tr.events) == 2 and tr.dropped == 3


def test_validate_command_line(tmp_path):
    """``python -m repro_torch.runtime.telemetry validate``: exit 0 and
    "ok" for a good file, exit 1 naming the problem for a bad one."""
    good = str(tmp_path / "good.json")
    write_chrome_trace(_good(), good, stats={"gen_tokens": 7.0})
    bad = str(tmp_path / "bad.jsonl")
    write_jsonl([_sp("run", 0.0, 1.0, uid=9, tid="slot0")], bad)
    cmd = [sys.executable, "-m", "repro_torch.runtime.telemetry", "validate"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parents[1] / "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = lambda args: subprocess.run(  # noqa: E731
        cmd + args, capture_output=True, text=True, env=env)
    ok = run([good])
    assert ok.returncode == 0 and ok.stdout.strip() == f"{good}: ok"
    fail = run([good, bad])
    assert fail.returncode == 1
    assert f"{bad}: 1 problem(s)" in fail.stdout
    assert "uid 9: 0 terminal events" in fail.stdout


# ---------------------------------------------------------------------------
# the metrics reference (docs/metrics_torch.md)
# ---------------------------------------------------------------------------

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs"


@pytest.fixture(scope="module")
def reference_doc():
    """The port's generated reference, from its battery of CPU serves."""
    return tele_t.reference_doc("cpu")


def _table_rows(text):
    return [line for line in text.splitlines() if line.startswith("|")]


def test_metrics_doc_is_generated(reference_doc):
    """docs/metrics_torch.md is ``reference_doc()`` as committed."""
    assert (DOCS / "metrics_torch.md").read_text(encoding="utf-8") == \
        reference_doc


def test_metrics_doc_rows_equal_reference(reference_doc):
    """Every row (name, kind, help) of the reference's docs/metrics.md, in
    its order: the port's serving stack registers the reference's metrics
    surface."""
    want = _table_rows((DOCS / "metrics.md").read_text(encoding="utf-8"))
    assert len(want) > 40
    assert _table_rows(reference_doc) == want


def test_reference_check_command(tmp_path, capsys):
    """``_main(["reference", "--device", "cpu", "--check", PATH])``: 0 for
    the committed doc, 1 naming the regeneration command for a stale copy.
    Without ``--device`` the battery serves on the card, as every entry
    point does, so it refuses where there is none."""
    doc = str(DOCS / "metrics_torch.md")
    cpu = ["reference", "--device", "cpu"]
    assert tele_t._main(cpu + ["--check", doc]) == 0
    assert capsys.readouterr().out.strip() == f"{doc}: up to date"
    stale = tmp_path / "stale.md"
    stale.write_text("# stale\n", encoding="utf-8")
    assert tele_t._main(cpu + ["--check", str(stale)]) == 1
    assert "repro_torch.runtime.telemetry reference --device cpu" in \
        capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tele_t._main(["reference", "--check", doc])


# ---------------------------------------------------------------------------
# engine: traced SLO serves against the reference
# ---------------------------------------------------------------------------


def _mixed_stream(n=8, n_high=3, seed=3):
    rng = np.random.default_rng(seed)
    reqs, prompts = [], {}
    for i in range(n):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append((i, plen, int(rng.integers(6, 14)),
                     1 if i >= n - n_high else 0))
    return reqs, prompts


def _scfg(chunk, trace, pool_blocks=10, port=False, **kw):
    """tests/test_telemetry.py's SLO ServerConfig (the reference's types,
    or the port's)."""
    if port:
        return ServerConfigT(
            batch_size=2, max_seq=96,
            kv_compress=kv_t.KVCompressConfig(**dataclasses.asdict(CCFG)),
            prefill_chunk=chunk,
            paged=kv_pool_t.PagedKVConfig(block_size=4,
                                          pool_blocks=pool_blocks),
            use_clustered_batching=False,
            scheduler=sched_t.SLOConfig(priority_admission=False),
            telemetry=TelemetryConfig(trace=trace, **kw))
    return ServerConfig(
        batch_size=2, max_seq=96, kv_compress=CCFG, prefill_chunk=chunk,
        paged=PagedKVConfig(block_size=4, pool_blocks=pool_blocks),
        use_clustered_batching=False,
        scheduler=SLOConfig(priority_admission=False),
        telemetry=tele_ref.TelemetryConfig(trace=trace))


class _Runs:
    """Each admission mode's SLO serve: the reference traced, the port
    traced and untraced; a serve is (tokens by uid, last_stats,
    last_trace, server)."""

    def __init__(self):
        self.params = ref_init_params(TINY)
        self.pt = bridge.params_from_numpy(
            jax.tree.map(np.asarray, self.params), TINY_T, "cpu")
        self._memo = {}

    def get(self, chunk):
        if chunk not in self._memo:
            reqs, prompts = _mixed_stream()
            out = {}
            ref = Server(TINY, _scfg(chunk, True), self.params)
            out["ref"] = self._serve(ref, [Request(*r) for r in reqs],
                                     prompts)
            for name, trace in (("port", True), ("untraced", False)):
                srv = ServerT(TINY_T, _scfg(chunk, trace, port=True),
                              self.pt, device="cpu")
                out[name] = self._serve(srv, [RequestT(*r) for r in reqs],
                                        prompts)
            self._memo[chunk] = out
        return self._memo[chunk]

    @staticmethod
    def _serve(srv, reqs, prompts):
        toks = {o.uid: o.tokens for o in srv.serve(reqs, prompts)}
        return toks, dict(srv.last_stats), srv.last_trace, srv


@pytest.fixture(scope="module")
def runs():
    return _Runs()


MODES = pytest.mark.parametrize("chunk", [8, 0], ids=["chunked", "blocking"])


@MODES
def test_tracing_is_schedule_invisible(runs, chunk):
    r = runs.get(chunk)
    assert r["port"][0] == r["untraced"][0] == r["ref"][0]
    assert r["untraced"][2] == []          # no tracer, no events
    assert r["untraced"][3].tracer is None


@MODES
def test_trace_validates_and_reconciles(runs, chunk):
    toks, st, evs, _ = runs.get(chunk)["port"]
    assert st["sched_preemptions"] >= 1.0 and st["sched_swaps_in"] >= 1.0
    assert validate_trace(evs, totals=st) == []
    names = {e["name"] for e in evs}
    want = {"state_families", "queued", "run", "first_token", "finish",
            "engine_step", "swap_out", "resume", "brownout", "compact"}
    want |= {"prefill_chunk", "absorb"} if chunk else {"prefill"}
    assert want <= names, want - names
    br = [e for e in evs if e["name"] == "brownout"]
    assert all("rung" in e["args"] and "why" in e["args"] for e in br)
    count = lambda name: sum(e["name"] == name for e in evs)  # noqa: E731
    assert count("swap_out") == st["sched_swaps_out"]
    assert count("resume") == st["sched_swaps_in"]


def _strip(events):
    return [(e["name"], e["ph"], e["pid"], e["tid"], e["uid"],
             {k: v for k, v in e["args"].items() if k not in TIMING_ARGS})
            for e in events]


@MODES
def test_event_sequence_equals_reference(runs, chunk):
    r = runs.get(chunk)
    got, want = _strip(r["port"][2]), _strip(r["ref"][2])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)


@MODES
def test_exported_trace_validates(runs, chunk, tmp_path):
    _, st, evs, srv = runs.get(chunk)["port"]
    chrome, jsonl = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    srv.export_trace(chrome)
    srv.export_trace(jsonl, fmt="jsonl")
    assert validate_chrome_file(chrome) == []
    assert validate_jsonl_file(jsonl) == []
    # the reference's validator takes the port's files too
    assert tele_ref.validate_chrome_file(chrome) == []
    with pytest.raises(ValueError):
        srv.export_trace(chrome, fmt="csv")
    ph = phase_breakdown(evs)
    assert ph.get("phase_swap_out_ms", 0.0) > 0.0
    assert ph.get("phase_resume_ms", 0.0) > 0.0
    assert set(ph) == set(phase_breakdown(runs.get(chunk)["ref"][2]))


def test_trace_resets_between_serves(runs):
    srv = ServerT(TINY_T, _scfg(8, True, pool_blocks=48, port=True),
                  runs.pt, device="cpu")
    reqs, prompts = _mixed_stream(n=3, n_high=0)
    reqs = [RequestT(*r) for r in reqs]
    srv.serve(reqs, prompts)
    first = srv.last_trace
    srv.serve(reqs, prompts)
    assert validate_trace(srv.last_trace, totals=srv.last_stats) == []
    assert srv.last_trace is not first
    assert _strip(srv.last_trace) == _strip(first)


def test_profiler_ranges_name_each_launch(runs):
    """``TelemetryConfig(jax_profiler=True)``: each engine launch runs
    inside a ``torch.profiler.record_function`` range."""
    srv = ServerT(TINY_T, _scfg(8, False, pool_blocks=48, port=True,
                                jax_profiler=True), runs.pt, device="cpu")
    reqs, prompts = _mixed_stream(n=3, n_high=0)
    with torch.profiler.profile() as prof:
        outs = srv.serve([RequestT(*r) for r in reqs], prompts)
    ranges = {e.key: e.count for e in prof.key_averages()}
    assert ranges.get("decode_packed") == srv.last_stats["decode_steps"]
    plain = ServerT(TINY_T, _scfg(8, False, pool_blocks=48, port=True),
                    runs.pt, device="cpu")
    assert ([o.tokens for o in plain.serve([RequestT(*r) for r in reqs],
                                           prompts)]
            == [o.tokens for o in outs])


def test_sched_keys_absent_without_scheduler(runs):
    reqs, prompts = _mixed_stream(n=3, n_high=0)
    srv = ServerT(TINY_T, ServerConfigT(
        batch_size=2, max_seq=96,
        kv_compress=kv_t.KVCompressConfig(**dataclasses.asdict(CCFG)),
        prefill_chunk=8, paged=kv_pool_t.PagedKVConfig(block_size=4)),
        runs.pt, device="cpu")
    srv.serve([RequestT(*r) for r in reqs], prompts)
    assert not any(k.startswith("sched_") for k in srv.last_stats)
    assert not any(k.startswith("template_") for k in srv.last_stats)

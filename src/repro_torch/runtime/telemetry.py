"""Serving telemetry: the typed metrics registry, the request-lifecycle
tracer and its exporters (port of ``repro.runtime.telemetry``; all host
side).

* :class:`MetricsRegistry` — named counters, gauges and histograms that
  the engine registers into; ``Server.last_stats`` is regenerated from the
  registry as a flat view, so the reference's key names carry over.
  ``begin_serve()`` drops per-serve metrics; lifetime metrics opt out with
  ``persist=True``.

* :class:`Tracer` — per-request lifecycle spans (queued → admit → prefill
  chunks → first token → decode → compact/absorb → preempt/swap → resume
  → finish/shed) and per-engine-step events, stamped with wall-clock,
  token position and pool-block deltas.  Off by default; when off the
  engine builds no event dicts.

* Exporters — JSONL event log and Chrome trace-event JSON loadable in
  Perfetto (one process per data shard, one thread per slot), plus
  :func:`validate_trace` / :func:`validate_chrome_file` schema checks,
  also from the command line::

      python -m repro_torch.runtime.telemetry validate <trace.json> ...

Event schema (internal form)::

    {"name": str, "ph": "i" | "X", "ts": float_us, "dur": float_us (X only),
     "pid": int_data_shard, "tid": "engine" | "queue" | "slot<K>",
     "uid": int | None, "args": {...}}

``ts`` is microseconds relative to the serve's ``t0``.

* :func:`reference_registry` / :func:`reference_doc` — every metric the
  serving stack can publish, collected from the live registrations of a
  battery of tiny serves; ``docs/metrics_torch.md`` is generated from
  them and checked for drift::

      python -m repro_torch.runtime.telemetry reference [--check PATH]
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

TRACE_SCHEMA = "repro-serve-trace-v1"


@dataclass(frozen=True)
class TelemetryConfig:
    """Per-server telemetry switches.

    trace:        record lifecycle + engine-step events (host-side only).
    jax_profiler: name kept from the reference, so configs stay parallel:
                  in the port it wraps each engine launch in a
                  ``torch.profiler.record_function`` range, so device
                  profiles line up with the host timeline.
    max_events:   tracer ring cap; events past it are counted as dropped.
    """

    trace: bool = False
    jax_profiler: bool = False
    max_events: int = 1_000_000


class Counter:
    """Monotone per-serve (or lifetime, with persist=True) counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", persist: bool = False):
        self.name = name
        self.help = help
        self.persist = persist
        self.value = 0.0

    def add(self, v: float = 1.0) -> None:
        self.value += float(v)

    def set_to(self, v: float) -> None:
        """Republish a lifetime total (monotone: never moves backwards)."""
        self.value = max(self.value, float(v))

    def view(self) -> Dict[str, float]:
        return {self.name: self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", persist: bool = False):
        self.name = name
        self.help = help
        self.persist = persist
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def view(self) -> Dict[str, float]:
        return {self.name: self.value}


#: Default histogram bucket upper bounds, in output units (after ``scale``).
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(2.0 ** e for e in range(-6, 16))


class Histogram:
    """Fixed-bucket histogram with exact quantiles while samples are
    retained (``np.percentile`` over the raw samples); past
    ``max_samples`` quantiles interpolate within the buckets."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        persist: bool = False,
        quantiles: Sequence[float] = (50, 95, 99),
        scale: float = 1.0,
        suffix: str = "",
        buckets: Optional[Sequence[float]] = None,
        max_samples: int = 65536,
    ):
        self.name = name
        self.help = help
        self.persist = persist
        self.quantiles = tuple(quantiles)
        self.scale = float(scale)
        self.suffix = suffix
        self.buckets = (tuple(buckets) if buckets is not None
                        else DEFAULT_BUCKETS)
        self.max_samples = int(max_samples)
        self.bucket_counts = np.zeros(len(self.buckets) + 1, dtype=np.int64)
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0  # in output units

    def observe(self, v: float) -> None:
        out = float(v) * self.scale
        self.bucket_counts[int(np.searchsorted(self.buckets, out))] += 1
        self.count += 1
        self.total += out
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))

    @property
    def exact(self) -> bool:
        return self.count == len(self.samples)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self.exact:
            return float(np.percentile(np.asarray(self.samples), q)
                         * self.scale)
        return self._bucket_quantile(q)

    def _bucket_quantile(self, q: float) -> float:
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            nxt = cum + int(c)
            if nxt >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1] * 2.0)
                frac = (target - cum) / max(int(c), 1)
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum = nxt
        return float(self.buckets[-1])

    def key(self, q: float) -> str:
        return f"{self.name}_p{int(q)}{self.suffix}"

    def view(self) -> Dict[str, float]:
        return {self.key(q): self.quantile(q) for q in self.quantiles}


class MetricsRegistry:
    """Ordered get-or-create registry of typed metrics."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind: str, factory) -> Any:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {kind}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                persist: bool = False) -> Counter:
        return self._get(name, "counter", lambda: Counter(name, help, persist))

    def gauge(self, name: str, help: str = "", persist: bool = False) -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(name, help, persist))

    def histogram(self, name: str, help: str = "", persist: bool = False,
                  **kw) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(name, help, persist, **kw))

    def begin_serve(self) -> None:
        """Drop every per-serve metric so stale dynamic keys cannot leak."""
        self._metrics = {k: m for k, m in self._metrics.items() if m.persist}

    def flat_view(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            out.update(m.view())
        return out

    def reference_table(self) -> str:
        """Markdown reference of every registered metric (for docs)."""
        lines = ["| metric | type | description |", "|---|---|---|"]
        for m in self._metrics.values():
            tag = " (lifetime)" if m.persist else ""
            if m.kind == "histogram":
                keys = ", ".join(f"`{m.key(q)}`" for q in m.quantiles)
                lines.append(f"| {keys} | histogram{tag} | {m.help} |")
            else:
                lines.append(f"| `{m.name}` | {m.kind}{tag} | {m.help} |")
        return "\n".join(lines)


def reference_registry(device=None) -> "MetricsRegistry":
    """A registry holding every metric the serving stack can publish.

    Built by running the reference's battery of tiny in-memory serves on
    the port's ``Server`` (on ``device``; None means CUDA) — the real
    registration calls in server / scheduler / pool / template store with
    their real help strings, so the generated reference cannot drift from
    the code.  Battery legs (each adds the families the previous legs
    cannot reach):

    1. mixed 'GM' clustered + paged + chunked + SLO scheduler — base
       engine metrics, frontier / recurrent retirement, both layer-state
       byte gauges, pool accounting, sched_* ladder
    2. windowed 'GL' clustered + paged + chunked — window retirement
    3. exact-KV paged — quota retirement
    4. clustered + paged + template store — template_* / prefix_*
    5. clustered dense — the non-paged KV-footprint gauges
    6. static batch engine — plan_waste

    Per-cluster template gauges collapse to one ``<C>`` placeholder row
    each, and the mesh-only metrics (per-data-shard waste), which a
    one-device battery cannot reach, are registered directly, with the
    reference's help strings."""
    import re
    from dataclasses import replace

    from repro_torch.core import kv_compress
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig, SSMConfig
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.runtime.template_store import TemplateStoreConfig

    gm = ModelConfig(name="ref-gm", family="hybrid", n_layers=2,
                     d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
                     d_ff=64, vocab=64, pad_vocab_multiple=16,
                     dtype="float32", layer_pattern="GM",
                     ssm=SSMConfig(d_state=8, d_conv=4, expand=2,
                                   head_dim=16, n_groups=1, chunk=16))
    g = ModelConfig(name="ref-g", family="dense", n_layers=2, d_model=32,
                    n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                    vocab=64, pad_vocab_multiple=16, dtype="float32")
    gl = replace(g, name="ref-gl", layer_pattern="GL", sliding_window=8)
    rng = np.random.default_rng(0)
    reqs = [Request(i, int(n), m) for i, (n, m) in
            enumerate([(20, 6), (7, 5), (14, 4)])]
    prompts = {r.uid: rng.integers(0, 64, size=(r.prompt_len,)).astype(
        np.int32) for r in reqs}
    ccfg = kv_compress.KVCompressConfig(n_clusters=4, iters=2,
                                        keep_recent=8, refresh_every=4)
    merged = MetricsRegistry()
    instanced = re.compile(r"template_cluster\d+_")

    def run(cfg, scfg):
        srv = Server(cfg, scfg, tfm.init_params(0, cfg, device=device),
                     device=device)
        srv.serve(reqs, prompts)
        for name, m in srv.metrics._metrics.items():
            # which cluster ids exist is a traffic artifact, not part of
            # the metrics surface: placeholder rows below
            if not instanced.match(name):
                merged._metrics.setdefault(name, m)

    run(gm, ServerConfig(batch_size=2, max_seq=48, kv_compress=ccfg,
                         prefill_chunk=8, paged=PagedKVConfig(block_size=4),
                         scheduler=SLOConfig()))
    run(gl, ServerConfig(batch_size=2, max_seq=48, kv_compress=ccfg,
                         prefill_chunk=8, paged=PagedKVConfig(block_size=4)))
    run(g, ServerConfig(batch_size=2, max_seq=48,
                        paged=PagedKVConfig(block_size=4)))
    run(g, ServerConfig(batch_size=2, max_seq=48, kv_compress=ccfg,
                        prefill_chunk=8, paged=PagedKVConfig(block_size=4),
                        template_store=TemplateStoreConfig()))
    run(g, ServerConfig(batch_size=2, max_seq=48, kv_compress=ccfg))
    run(g, ServerConfig(batch_size=2, max_seq=48, engine="static",
                        use_clustered_batching=False))
    # per-cluster placeholders (help strings mirror template_store.py)
    merged.gauge("template_cluster<C>_cohesion",
                 "cluster <C>: matched/prompt cohesion")
    merged.gauge("template_cluster<C>_hit_rate",
                 "cluster <C>: hits per member admission")
    merged.gauge("template_cluster<C>_bytes_pinned",
                 "cluster <C>: bytes pinned by its entries")
    # mesh-only (the reference's engine registers these when
    # n_data_shards > 1; help strings mirror its runtime/server.py)
    merged.gauge("n_data_shards", "data shards this serve")
    merged.gauge("slot_waste_shard<S>",
                 "idle slot-step fraction on data shard <S>")
    return merged


def reference_doc(device=None) -> str:
    """The committed ``docs/metrics_torch.md`` content."""
    return (
        "# Serving metrics reference (PyTorch port)\n\n"
        "Every metric the port's serving engine can publish into "
        "`Server.last_stats`, in registration order.  Generated by "
        "`python -m repro_torch.runtime.telemetry reference` from the live "
        "registrations (a battery of tiny in-memory serves) — do not "
        "edit by hand; `--check` fails on drift.  Its rows are those of "
        "the reference's `docs/metrics.md`.\n\n"
        "Per-serve metrics reset at each `serve()`; metrics tagged "
        "*(lifetime)* persist across serves on the same `Server`.  "
        "`<S>` ranges over data shards on a mesh; "
        "`template_cluster<C>_*` gauges appear per online traffic "
        "cluster when a template store is configured.\n\n"
        + reference_registry(device).reference_table() + "\n")


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Host-side event recorder for one serve at a time."""

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self.t0 = 0.0
        self.n_shards = 1

    def begin_serve(self, t0: float, n_shards: int = 1) -> None:
        self.events = []
        self.dropped = 0
        self.t0 = float(t0)
        self.n_shards = max(int(n_shards), 1)

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def event(
        self,
        name: str,
        pid: int = 0,
        tid: str = "engine",
        uid: Optional[int] = None,
        t: Optional[float] = None,
        **args: Any,
    ) -> None:
        """Record an instant event at wall-clock ``t`` (defaults to now)."""
        if t is None:
            t = time.perf_counter()
        self._push(
            {
                "name": name,
                "ph": "i",
                "ts": (t - self.t0) * 1e6,
                "pid": int(pid),
                "tid": tid,
                "uid": uid,
                "args": args,
            }
        )

    def span(
        self,
        name: str,
        t_start: float,
        t_end: float,
        pid: int = 0,
        tid: str = "engine",
        uid: Optional[int] = None,
        **args: Any,
    ) -> None:
        self._push(
            {
                "name": name,
                "ph": "X",
                "ts": (t_start - self.t0) * 1e6,
                "dur": max((t_end - t_start) * 1e6, 0.0),
                "pid": int(pid),
                "tid": tid,
                "uid": uid,
                "args": args,
            }
        )

    def finish(self) -> List[Dict[str, Any]]:
        evs = self.events
        self.events = []
        return evs


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

#: (span/instant name, registry total key) pairs reconciled by validate_trace.
_TOTALS: Tuple[Tuple[str, str], ...] = (
    ("swap_out", "sched_swaps_out"),
    ("resume", "sched_swaps_in"),
    ("shed", "sched_sheds"),
    ("prefill_chunk", "prefill_chunks"),
    ("absorb", "kv_absorbs"),
    ("compact", "kv_compactions"),
    ("engine_step", "decode_steps"),
)


def validate_trace(
    events: Sequence[Dict[str, Any]],
    totals: Optional[Dict[str, float]] = None,
) -> List[str]:
    """Check trace-schema invariants; return a list of problem strings.

    1. every uid that ever ran (has a ``run`` span) emits exactly one terminal
       event (``finish`` or ``shed``); no uid emits more than one terminal;
    2. X-spans nest well-formed per (pid, tid) track;
    3. swap_out / resume events pair up per uid (no double-park, no resume of
       a non-parked uid; a still-parked uid must have a ``shed`` terminal);
    4. when ``totals`` is given, event counts reconcile with registry totals
       and run-span token deltas sum to ``gen_tokens``.
    """
    problems: List[str] = []

    ran = {e["uid"] for e in events if e["name"] == "run" and e["uid"] is not None}
    terminals: Dict[int, int] = {}
    for e in events:
        if e["name"] in ("finish", "shed") and e["uid"] is not None:
            terminals[e["uid"]] = terminals.get(e["uid"], 0) + 1
    for uid in sorted(ran):
        c = terminals.get(uid, 0)
        if c != 1:
            problems.append(f"uid {uid}: {c} terminal events (expected exactly 1)")
    for uid, c in sorted(terminals.items()):
        if uid not in ran and c > 1:
            problems.append(f"uid {uid}: {c} terminal events without a run span")

    # span nesting per track
    by_track: Dict[Tuple[int, str], List[Dict[str, Any]]] = {}
    for e in events:
        if e["ph"] == "X":
            by_track.setdefault((e["pid"], e["tid"]), []).append(e)
    for (pid, tid), evs in sorted(by_track.items()):
        evs = sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[float] = []
        for e in evs:
            end = e["ts"] + e.get("dur", 0.0)
            while stack and e["ts"] >= stack[-1]:
                stack.pop()
            if stack and end > stack[-1] + 1e-6:
                problems.append(
                    f"track ({pid},{tid}): span {e['name']!r} at ts={e['ts']:.1f} "
                    f"partially overlaps enclosing span"
                )
                continue
            stack.append(end)

    # swap pairing per uid
    parked: Dict[int, bool] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        uid = e.get("uid")
        if uid is None:
            continue
        if e["name"] == "swap_out":
            if parked.get(uid):
                problems.append(f"uid {uid}: swap_out while already parked")
            parked[uid] = True
        elif e["name"] == "resume":
            if not parked.get(uid):
                problems.append(f"uid {uid}: resume without matching swap_out")
            parked[uid] = False
    shed_uids = {e["uid"] for e in events if e["name"] == "shed" and e["uid"] is not None}
    for uid, p in sorted(parked.items()):
        if p and uid not in shed_uids:
            problems.append(f"uid {uid}: still parked at end of trace without shed")

    if totals is not None:
        counts: Dict[str, int] = {}
        for e in events:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        for ev_name, key in _TOTALS:
            if key in totals:
                got, want = counts.get(ev_name, 0), int(totals[key])
                if got != want:
                    problems.append(
                        f"count({ev_name})={got} != {key}={want}"
                    )
        if "gen_tokens" in totals:
            toks = sum(
                int(e["args"].get("tokens", 0))
                for e in events
                if e["name"] == "run"
            )
            if toks != int(totals["gen_tokens"]):
                problems.append(
                    f"run-span token sum {toks} != gen_tokens {int(totals['gen_tokens'])}"
                )

    return problems


def phase_breakdown(events: Sequence[Dict[str, Any]]) -> Dict[str, float]:
    """Per-phase wall-time breakdown (milliseconds) from a trace."""
    out: Dict[str, float] = {}
    for e in events:
        if e["ph"] != "X":
            continue
        ms = e.get("dur", 0.0) / 1e3
        if e["name"] == "engine_step":
            kind = e["args"].get("kind", "decode")
            key = f"phase_{kind}_ms"
        elif e["name"] in ("compact", "absorb", "swap_out", "resume", "prefill"):
            key = f"phase_{e['name']}_ms"
        else:
            continue
        out[key] = out.get(key, 0.0) + ms
    return {k: float(v) for k, v in sorted(out.items())}


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def write_jsonl(
    events: Sequence[Dict[str, Any]],
    path: str,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    with open(path, "w") as f:
        if meta is not None:
            f.write(json.dumps({"schema": TRACE_SCHEMA, **meta}) + "\n")
        for e in events:
            f.write(json.dumps(e) + "\n")


def _tid_num(tid: str) -> int:
    if tid == "engine":
        return 0
    if tid == "queue":
        return 1
    if tid.startswith("slot"):
        return int(tid[4:]) + 2
    return 999


def write_chrome_trace(
    events: Sequence[Dict[str, Any]],
    path: str,
    n_shards: int = 1,
    stats: Optional[Dict[str, float]] = None,
) -> None:
    """Export a Chrome trace-event JSON file loadable in Perfetto.

    One process per data shard, threads ``engine`` / ``queue`` / ``slot<K>``.
    ``stats`` (typically ``server.last_stats``) is embedded in ``otherData``
    so :func:`validate_chrome_file` can reconcile counts offline.
    """
    traceEvents: List[Dict[str, Any]] = []
    tids_seen: Dict[int, Dict[str, int]] = {}
    for e in events:
        pid = int(e["pid"])
        tid = _tid_num(e["tid"])
        tids_seen.setdefault(pid, {})[e["tid"]] = tid
        args = dict(e.get("args") or {})
        if e.get("uid") is not None:
            args["uid"] = e["uid"]
        out = {
            "name": e["name"],
            "cat": "serve",
            "ph": e["ph"],
            "ts": e["ts"],
            "pid": pid,
            "tid": tid,
            "args": args,
        }
        if e["ph"] == "X":
            out["dur"] = e.get("dur", 0.0)
        else:
            out["s"] = "t"
        traceEvents.append(out)
    for pid, tids in sorted(tids_seen.items()):
        traceEvents.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"data shard {pid}"},
            }
        )
        for tname, tnum in sorted(tids.items(), key=lambda kv: kv[1]):
            traceEvents.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tnum,
                    "args": {"name": tname},
                }
            )
            traceEvents.append(
                {
                    "name": "thread_sort_index",
                    "ph": "M",
                    "pid": pid,
                    "tid": tnum,
                    "args": {"sort_index": tnum},
                }
            )
    other: Dict[str, Any] = {"schema": TRACE_SCHEMA, "n_shards": int(n_shards)}
    if stats is not None:
        other["last_stats"] = {k: float(v) for k, v in stats.items()}
    with open(path, "w") as f:
        json.dump(
            {
                "traceEvents": traceEvents,
                "displayTimeUnit": "ms",
                "otherData": other,
            },
            f,
        )


def events_from_chrome(obj: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Reconstruct internal events from a Chrome trace-event JSON object."""
    names: Dict[Tuple[int, int], str] = {}
    for e in obj.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[(int(e["pid"]), int(e["tid"]))] = e["args"]["name"]
    out: List[Dict[str, Any]] = []
    for e in obj.get("traceEvents", []):
        if e.get("ph") not in ("i", "X"):
            continue
        args = dict(e.get("args") or {})
        uid = args.pop("uid", None)
        ev = {
            "name": e["name"],
            "ph": e["ph"],
            "ts": float(e["ts"]),
            "pid": int(e["pid"]),
            "tid": names.get((int(e["pid"]), int(e["tid"])), "engine"),
            "uid": uid,
            "args": args,
        }
        if e["ph"] == "X":
            ev["dur"] = float(e.get("dur", 0.0))
        out.append(ev)
    return out


def validate_chrome_file(path: str, reconcile: bool = True) -> List[str]:
    """Parse + validate an exported Chrome trace file; return problems."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable chrome trace {path}: {e}"]
    problems: List[str] = []
    other = obj.get("otherData") or {}
    if other.get("schema") != TRACE_SCHEMA:
        problems.append(
            f"schema mismatch: {other.get('schema')!r} != {TRACE_SCHEMA!r}"
        )
    events = events_from_chrome(obj)
    totals = other.get("last_stats") if reconcile else None
    problems.extend(validate_trace(events, totals=totals))
    return problems


def validate_jsonl_file(path: str, reconcile: bool = True) -> List[str]:
    try:
        meta: Optional[Dict[str, Any]] = None
        events: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if "schema" in obj and "ph" not in obj:
                    meta = obj
                    continue
                events.append(obj)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable jsonl trace {path}: {e}"]
    totals = (meta or {}).get("last_stats") if reconcile else None
    return validate_trace(events, totals=totals)


# ---------------------------------------------------------------------------
# torch.profiler integration
# ---------------------------------------------------------------------------


def annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: the
    port's form of the reference's ``jax.profiler`` annotation."""
    import torch.profiler

    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.runtime.telemetry validate <trace.json> ...
#      python -m repro_torch.runtime.telemetry reference [--check PATH]
#                                                      [--device DEV]
# ---------------------------------------------------------------------------


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.runtime.telemetry")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="validate exported trace files")
    v.add_argument("paths", nargs="+")
    v.add_argument(
        "--no-reconcile",
        action="store_true",
        help="skip reconciling event counts against embedded last_stats",
    )
    r = sub.add_parser(
        "reference",
        help="emit the metrics reference doc (docs/metrics_torch.md)",
    )
    r.add_argument(
        "--check",
        metavar="PATH",
        default=None,
        help="compare against an existing file instead of printing; "
        "exit 1 if it is out of date",
    )
    r.add_argument(
        "--device",
        default=None,
        help="device the battery serves on (default: cuda; pass cpu "
        "where there is no card)",
    )
    args = ap.parse_args(argv)

    if args.cmd == "reference":
        doc = reference_doc(args.device)
        if args.check is None:
            print(doc, end="")
            return 0
        try:
            with open(args.check, "r", encoding="utf-8") as f:
                on_disk = f.read()
        except OSError as e:
            print(f"{args.check}: {e}")
            return 1
        if on_disk != doc:
            dev = "" if args.device is None else f" --device {args.device}"
            print(f"{args.check}: out of date — regenerate with "
                  f"`python -m repro_torch.runtime.telemetry reference{dev} > "
                  f"{args.check}`")
            return 1
        print(f"{args.check}: up to date")
        return 0

    rc = 0
    for path in args.paths:
        if path.endswith(".jsonl"):
            problems = validate_jsonl_file(path, reconcile=not args.no_reconcile)
        else:
            problems = validate_chrome_file(path, reconcile=not args.no_reconcile)
        if problems:
            rc = 1
            print(f"{path}: {len(problems)} problem(s)")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"{path}: ok")
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())

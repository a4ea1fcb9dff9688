"""Serving telemetry: request-lifecycle tracing, metrics, Perfetto export
— the port's own copy of ``repro.serving.telemetry`` (numpy only).

It records *when* and *why* the serving stack (continuous batching, paged
KV, preempt-and-swap, and a replica router) did what it did:

  * ``Tracer`` — an in-memory event recorder threaded through
    ``ContinuousScheduler``, ``ReplicaRouter``, ``PagedKVSlotAllocator``,
    ``SwapLedger``, and ``Engine.step``.  Per-request lifecycle events
    (submit → dispatch/requeue → admit → first_token → preempt/resume →
    retire, or reject) and per-step timeline events (slot decode/ramp,
    page alloc/free, swap in/out, idle gaps) are recorded as typed
    ``TraceEvent`` rows with the scheduler step as the clock.
  * ``MetricsRegistry`` — named monotonic counters and point-in-time
    gauges (tokens, free pages, queue depth, preemptions, kernel
    grid-steps/skipped-blocks) with one ``snap()`` row per step, exported
    as JSONL (one JSON object per line: ``{"step": t, "r0/free_pages":
    ..., ...}``; metric names are prefixed ``r{replica}/`` or
    ``router/`` by the scope that recorded them).
  * Chrome/Perfetto export — ``Tracer.chrome_trace()`` renders the event
    log as a ``traceEvents`` JSON (load it at https://ui.perfetto.dev):
    one process per replica (plus one for the router), one thread per
    slot with ``X`` duration events per decode step, async span trees per
    request (``queued`` → ``ramp``/``decode`` with ``parked``
    interruptions), instant events for page/swap traffic, and ``C``
    counter tracks from the metric rows.

Zero-overhead contract: every recorder handle defaults to the
``NULL_TRACER`` singleton whose methods are no-ops and whose ``enabled``
flag gates all non-trivial collection, so a serve without ``--trace`` /
``--metrics`` executes the exact pre-telemetry path — bitwise-identical
tokens, step counts, and page traffic.  Telemetry never feeds back into
scheduling: a traced run is bitwise-identical to an untraced one too
(pinned in ``tests/test_telemetry.py``).

The scheduler-side clock is the *decode step*, not wall time — spans are
exact replays of scheduler decisions, so tests can assert span sequence ==
scheduler event log.  Export maps one step to ``STEP_US`` microseconds so
Perfetto renders readable track widths; ``Engine.step`` additionally
stamps host wall-clock dispatch time per step as an instant event.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Optional

import numpy as np

# Chrome trace timestamps are microseconds; one scheduler step renders as
# 1ms so smoke-scale traces are legible without zooming.
STEP_US = 1000

# Scope id the router records under (replicas use their index >= 0).
ROUTER_SCOPE = -1

# Request-lifecycle kinds (everything else is timeline/step-scoped).
LIFECYCLE_KINDS = ("submit", "dispatch", "requeue", "admit", "first_token",
                   "preempt", "resume", "retire", "reject")


@dataclasses.dataclass
class TraceEvent:
    """One recorded event.  ``ts`` is the scheduler clock in steps;
    ``seq`` is a global tiebreaker preserving emission order within a
    step.  ``rid`` is set for lifecycle events, ``slot`` for slot-scoped
    timeline events; ``args`` carries kind-specific detail."""
    ts: int
    seq: int
    kind: str
    replica: int
    rid: Optional[int] = None
    slot: Optional[int] = None
    lane: Optional[int] = None
    args: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named counters (monotonic) and gauges (point-in-time), with one
    snapshot row per step.  The registry is shared across scopes — a
    router tick's row covers the whole fleet — and every value is a plain
    Python number, so rows serialise directly to JSONL."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.rows: list[dict] = []

    def count(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def snapshot(self) -> dict:
        """Flat {name: value} view of every counter and gauge."""
        return {**self.counters, **self.gauges}

    def snap(self, step: int) -> dict:
        """Append (and return) one per-step snapshot row."""
        row = {"step": int(step), **self.snapshot()}
        self.rows.append(row)
        return row

    def write_jsonl(self, path: str) -> int:
        """One JSON object per line, one line per snapped step."""
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")
        return len(self.rows)


class _PrefixedMetrics:
    """Scope view of a shared registry: names gain a ``r{i}/`` (or
    ``router/``) prefix so per-replica series stay distinct in one row."""

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self._registry = registry
        self._prefix = prefix

    def count(self, name: str, value: float = 1) -> None:
        self._registry.count(self._prefix + name, value)

    def gauge(self, name: str, value: float) -> None:
        self._registry.gauge(self._prefix + name, value)


# ---------------------------------------------------------------------------
# Null tracer (the default recorder handle)
# ---------------------------------------------------------------------------

class _NullMetrics:
    def count(self, name, value=1):
        pass

    def gauge(self, name, value):
        pass


class NullTracer:
    """No-op recorder: the default handle everywhere a tracer threads
    through.  ``enabled`` is False so call sites skip any non-trivial
    collection; the methods themselves are safe no-ops, so cheap
    unconditional calls (one per park, per page burst, ...) cost a single
    Python call on the off path."""

    enabled = False
    now = 0
    owns_snapshots = False
    emit_submit = False
    metrics = _NullMetrics()

    def scope(self, replica: int) -> "NullTracer":
        return self

    def event(self, kind: str, **kw) -> None:
        pass

    def snap(self, step: int) -> None:
        pass


NULL_TRACER = NullTracer()


def as_scope(tracer, replica: int = 0):
    """Normalise a recorder handle: None -> NULL_TRACER, a ``Tracer`` ->
    its ``scope(replica)``, an existing scope (or the null) passes
    through."""
    if tracer is None:
        return NULL_TRACER
    if isinstance(tracer, Tracer):
        return tracer.scope(replica)
    return tracer


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

class _Scope:
    """A tracer bound to one replica id.  Shares the event list and
    metrics registry with its parent ``Tracer``; carries its own ``now``
    clock (replicas under a router advance independently) and an
    ``owns_snapshots`` flag so exactly one scope per run emits the
    per-step metric rows (the router demotes its replicas' scopes and
    snaps once per tick itself)."""

    enabled = True

    def __init__(self, tracer: "Tracer", replica: int):
        self.tracer = tracer
        self.replica = replica
        self.now = 0
        self.owns_snapshots = True
        # A router-managed replica's scope does not emit "submit": the
        # request's span opened at the router, and dispatch hands it over.
        self.emit_submit = True
        prefix = "router/" if replica == ROUTER_SCOPE else f"r{replica}/"
        self.metrics = _PrefixedMetrics(tracer.metrics, prefix)

    def event(self, kind: str, *, ts: Optional[int] = None, rid=None,
              slot=None, lane=None, **args) -> None:
        self.tracer.record(TraceEvent(
            ts=int(self.now if ts is None else ts), seq=self.tracer.next_seq(),
            kind=kind, replica=self.replica, rid=rid, slot=slot, lane=lane,
            args=args))

    def snap(self, step: int) -> None:
        if self.owns_snapshots:
            self.tracer.metrics.snap(step)


class Tracer:
    """In-memory serving trace: typed event log + metrics registry.

    Construct one per serve, hand it to ``ContinuousScheduler(...,
    tracer=...)`` or ``ReplicaRouter(..., tracer=...)``, and export after
    the run with ``export_chrome(path)`` / ``metrics.write_jsonl(path)``.
    ``scope(i)`` binds a view for replica ``i`` (the router uses
    ``ROUTER_SCOPE``); all scopes append to one ordered event list."""

    enabled = True

    def __init__(self):
        self.events: list[TraceEvent] = []
        self.metrics = MetricsRegistry()
        self._seq = 0
        self._scopes: dict[int, _Scope] = {}

    # -- recording -----------------------------------------------------------

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def record(self, event: TraceEvent) -> None:
        self.events.append(event)

    def scope(self, replica: int) -> _Scope:
        if replica not in self._scopes:
            self._scopes[replica] = _Scope(self, replica)
        return self._scopes[replica]

    # -- queries (tests, bench summaries) -------------------------------------

    def request_log(self, rid: int) -> list[TraceEvent]:
        """Lifecycle events of one request, in emission order."""
        return [e for e in self.events
                if e.rid == rid and e.kind in LIFECYCLE_KINDS]

    def request_ids(self) -> list[int]:
        return sorted({e.rid for e in self.events
                       if e.rid is not None and e.kind in LIFECYCLE_KINDS})

    def ttfts(self) -> dict[int, int]:
        """Trace-derived time-to-first-token per rid (submit ->
        first_token), for requests whose first token landed."""
        first: dict[int, TraceEvent] = {}
        sub: dict[int, TraceEvent] = {}
        for e in self.events:
            if e.kind == "submit" and e.rid not in sub:
                sub[e.rid] = e
            elif e.kind == "first_token" and e.rid not in first:
                first[e.rid] = e
        return {r: first[r].ts - sub[r].ts for r in first if r in sub}

    # -- lifecycle validation ---------------------------------------------------

    def lifecycle_errors(self, *, drained: bool = True) -> list[str]:
        """Structural problems in the per-request span log; empty when the
        trace is well-formed.  With ``drained`` (the post-``run`` state):
        every submitted-and-not-rejected rid opened exactly once (submit)
        and closed exactly once (retire), no span survives the drain, and
        preempt/resume pairs alternate and balance (nest correctly inside
        admit → retire)."""
        errors = []
        for rid in self.request_ids():
            log = self.request_log(rid)
            kinds = [e.kind for e in log]
            if "reject" in kinds:
                if kinds.count("submit") or "admit" in kinds:
                    errors.append(f"rid {rid}: rejected but has "
                                  f"submit/admit events: {kinds}")
                continue
            if kinds.count("submit") != 1:
                errors.append(f"rid {rid}: {kinds.count('submit')} submit "
                              f"events (want exactly 1)")
            if drained and kinds.count("retire") != 1:
                errors.append(f"rid {rid}: {kinds.count('retire')} retire "
                              f"events (span survived drain)")
            if kinds.count("admit") != (1 if "admit" in kinds else 0) or \
                    (drained and "admit" not in kinds):
                errors.append(f"rid {rid}: bad admit count in {kinds}")
            if kinds.count("first_token") > 1:
                errors.append(f"rid {rid}: duplicate first_token")
            # preempt/resume must alternate starting with preempt, inside
            # admit..retire, and balance by drain time.
            depth = 0
            admitted = retired = False
            for e in log:
                if e.kind == "admit":
                    admitted = True
                elif e.kind == "retire":
                    retired = True
                elif e.kind == "preempt":
                    if not admitted or retired or depth != 0:
                        errors.append(f"rid {rid}: preempt outside a "
                                      f"running span ({kinds})")
                    depth += 1
                elif e.kind == "resume":
                    if depth != 1:
                        errors.append(f"rid {rid}: resume without matching "
                                      f"preempt ({kinds})")
                    depth -= 1
            if drained and depth != 0:
                errors.append(f"rid {rid}: {depth} unresumed preemption(s) "
                              f"survived drain")
            ts = [e.ts for e in log]
            if ts != sorted(ts):
                errors.append(f"rid {rid}: timestamps not monotone: {ts}")
        return errors

    # -- Chrome/Perfetto export -------------------------------------------------

    def _pid(self, replica: int, max_replica: int) -> int:
        return max_replica + 1 if replica == ROUTER_SCOPE else replica

    def chrome_trace(self) -> dict:
        """Render the event log as Chrome ``traceEvents`` JSON (Perfetto
        loads it directly): per-replica processes, per-slot threads with
        duration events for each decode/ramp step, async span trees per
        request, instants for page/swap traffic, counter tracks from the
        metric rows."""
        out: list[dict] = []
        replicas = sorted({e.replica for e in self.events
                           if e.replica != ROUTER_SCOPE}) or [0]
        max_rep = max(replicas)
        pids = {r: self._pid(r, max_rep)
                for r in set([e.replica for e in self.events] + [0])}

        # Process/thread naming metadata.
        for r, pid in sorted(pids.items()):
            name = "router" if r == ROUTER_SCOPE else f"replica {r}"
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": 0, "args": {"name": "scheduler"}})
        for e in self.events:
            if e.slot is not None:
                out.append({"ph": "M", "name": "thread_name",
                            "pid": pids[e.replica], "tid": e.slot + 1,
                            "args": {"name": f"slot {e.slot}"}})
        # Dedup metadata (dict rows are unhashable; JSON key works).
        seen = set()
        out = [r for r in out
               if (k := json.dumps(r, sort_keys=True)) not in seen
               and not seen.add(k)]

        # Timeline events.
        for e in self.events:
            pid = pids[e.replica]
            us = e.ts * STEP_US
            if e.kind == "slot_step":
                adv = int(e.args.get("advance", 1))
                out.append({
                    "ph": "X", "name": "ramp" if e.args.get("ramping")
                    else "decode", "cat": "step", "pid": pid,
                    "tid": e.slot + 1, "ts": us, "dur": adv * STEP_US,
                    "args": e.args})
            elif e.kind in ("page_alloc", "page_free", "swap_out", "swap_in",
                            "engine_step", "idle", "dispatch", "requeue",
                            "reject"):
                tid = 0 if e.slot is None else e.slot + 1
                args = dict(e.args)
                if e.rid is not None:
                    args["rid"] = e.rid
                out.append({"ph": "i", "s": "t", "name": e.kind,
                            "cat": "timeline", "pid": pid, "tid": tid,
                            "ts": us, "args": args})

        # Async span tree per request, replayed from the lifecycle log.
        for rid in self.request_ids():
            log = self.request_log(rid)
            if not any(e.kind == "submit" for e in log):
                continue                      # rejected before entering
            serve = next((e.replica for e in log
                          if e.kind in ("admit", "retire")), log[0].replica)
            pid = pids.get(serve, pids[0])
            aid = str(rid)

            def async_ev(ph, name, ts):
                return {"ph": ph, "name": name, "cat": "request", "id": aid,
                        "pid": pid, "tid": 0, "ts": ts * STEP_US}

            open_seg = None                   # (name, since-ts)
            interrupted = None                # segment name a park paused
            last_ts = log[-1].ts
            emitted: list[dict] = []
            for e in log:
                if e.kind == "submit":
                    emitted.append(async_ev("b", f"request {rid}", e.ts))
                    open_seg = ("queued", e.ts)
                    emitted.append(async_ev("b", "queued", e.ts))
                elif e.kind == "admit":
                    if open_seg:
                        emitted.append(async_ev("e", open_seg[0], e.ts))
                    open_seg = ("ramp", e.ts)
                    emitted.append(async_ev("b", "ramp", e.ts))
                elif e.kind == "first_token":
                    emitted.append(async_ev("n", "first_token", e.ts))
                    if open_seg and open_seg[0] == "ramp":
                        emitted.append(async_ev("e", "ramp", e.ts))
                        open_seg = ("decode", e.ts)
                        emitted.append(async_ev("b", "decode", e.ts))
                elif e.kind == "preempt":
                    if open_seg:
                        emitted.append(async_ev("e", open_seg[0], e.ts))
                        interrupted = open_seg[0]
                    open_seg = ("parked", e.ts)
                    emitted.append(async_ev("b", "parked", e.ts))
                elif e.kind == "resume":
                    if open_seg:
                        emitted.append(async_ev("e", open_seg[0], e.ts))
                    open_seg = (interrupted or "decode", e.ts)
                    emitted.append(async_ev("b", open_seg[0], e.ts))
                elif e.kind == "retire":
                    if open_seg:
                        emitted.append(async_ev("e", open_seg[0], e.ts))
                        open_seg = None
                    emitted.append(async_ev("e", f"request {rid}", e.ts))
            if open_seg:                      # max_steps bail: close cleanly
                emitted.append(async_ev("e", open_seg[0], last_ts))
                emitted.append(async_ev("e", f"request {rid}", last_ts))
            out.extend(emitted)

        # Counter tracks from the per-step metric rows.
        for row in self.metrics.rows:
            us = row["step"] * STEP_US
            for key, value in row.items():
                if key == "step":
                    continue
                scope, _, name = key.partition("/")
                pid = pids[ROUTER_SCOPE] if scope == "router" \
                    else pids.get(int(scope[1:]) if scope[1:].isdigit()
                                  else 0, pids[0])
                out.append({"ph": "C", "name": name, "cat": "metrics",
                            "pid": pid, "tid": 0, "ts": us,
                            "args": {"value": value}})

        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"clock": f"scheduler step ({STEP_US} us/step)",
                             "steps": max((e.ts for e in self.events),
                                          default=0)}}

    def export_chrome(self, path: str) -> int:
        """Write the Chrome/Perfetto trace; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# Paged-kernel K-block accounting
# ---------------------------------------------------------------------------

def kblock_stats(block_table: np.ndarray, kblock: int,
                 kv_heads: int) -> tuple[int, int, int]:
    """K-block iteration of one paged-decode kernel launch over
    ``block_table`` (B, max_pages): (K-blocks walked, all-unmapped K-blocks
    skipped, mapped block-table entries), summed over the launch's
    (slot, KV head) thread blocks.  Each thread block walks its slot's
    entries ``kblock`` at a time, the last K-block running past the table's
    end; every layer launches over the same table, so per-step totals are
    ``n_layers *`` these."""
    b, mp = block_table.shape
    pad = -mp % kblock
    if pad:
        block_table = np.concatenate(
            [block_table, np.full((b, pad), -1, block_table.dtype)], axis=1)
    blocks = block_table.reshape(b, -1, kblock)
    grid = b * blocks.shape[1] * kv_heads
    skipped = int((blocks < 0).all(axis=2).sum()) * kv_heads
    mapped_rows = int((blocks >= 0).sum()) * kv_heads
    return grid, skipped, mapped_rows


# ---------------------------------------------------------------------------
# Trace-derived summaries (benchmarks attach these to results JSON)
# ---------------------------------------------------------------------------

def ttft_histogram(tracer: Tracer) -> dict:
    """Power-of-two-bucketed TTFT histogram from the span log (submit ->
    first_token, in steps): {"0-1": n, "2-3": n, "4-7": n, ...}."""
    hist: dict[str, int] = {}
    for ttft in tracer.ttfts().values():
        lo = 0 if ttft <= 1 else 2 ** int(np.log2(max(2, ttft)))
        hi = max(1, 2 * lo - 1)
        hist[f"{lo}-{hi}"] = hist.get(f"{lo}-{hi}", 0) + 1
    return dict(sorted(hist.items(), key=lambda kv: int(kv[0].split("-")[0])))


def page_pool_timeline(tracer: Tracer, *, max_points: int = 64) -> dict:
    """Page-pool occupancy over time from the metric rows: the high-water
    mark plus an (evenly downsampled) [step, pages_in_use] series summed
    across replicas."""
    series = []
    for row in tracer.metrics.rows:
        pages = sum(v for k, v in row.items() if k.endswith("pages_in_use"))
        if any(k.endswith("pages_in_use") for k in row):
            series.append([row["step"], int(pages)])
    if not series:
        return {}
    high_water = max(p for _, p in series)
    if len(series) > max_points:
        idx = np.linspace(0, len(series) - 1, max_points).astype(int)
        series = [series[i] for i in idx]
    return {"high_water": high_water, "series": series}


def trace_summary(tracer: Tracer) -> dict:
    """The trace-derived record benchmarks attach to results JSON."""
    counts: dict[str, int] = {}
    for e in tracer.events:
        counts[e.kind] = counts.get(e.kind, 0) + 1
    out = {"events": len(tracer.events),
           "event_counts": dict(sorted(counts.items())),
           "ttft_hist": ttft_histogram(tracer)}
    pool = page_pool_timeline(tracer)
    if pool:
        out["page_pool"] = pool
    return out

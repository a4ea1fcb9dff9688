"""Replica router: a multi-engine serving tier with load-aware dispatch —
the port of ``repro.serving.router``.

One ``ContinuousScheduler`` owns one engine, one slot table, and one page
pool — a single-process ceiling.  This module is the tier above it on the
road to multi-host serving (ROADMAP "multi-host sharded serving"): a
``ReplicaRouter`` owns R independent ``Engine`` + ``ContinuousScheduler``
replicas (each with its own slot table, page pool, and policy stack) and
dispatches incoming requests across them:

  * requests queue at the *router*; each tick the router offers arrived
    requests to a pluggable ``RoutingPolicy`` resolved by name from a
    registry (mirroring ``serving/policies.py``) together with every
    candidate replica's ``SchedulerLoad`` snapshot — the public probe the
    scheduler exposes instead of its internals;
  * ``round_robin`` cycles replicas and never exerts backpressure (the
    replica's own admission queue absorbs the wait) — with R = 1 dispatch
    is the identity and the router reproduces the bare scheduler's token
    stream bitwise;
  * ``least_loaded`` binds late: a request stays at the router until some
    replica has a free lane, then goes to the one with the most free lanes
    + free pages — early binding to a busy replica is what skews load;
  * ``slo_headroom`` routes top-rank (latency-class) traffic to the replica
    whose admission-horizon headroom — the ``_sim_ends``-derived probe —
    is largest, and everything else least-loaded;
  * replica-full backpressure *requeues at the router* (the request simply
    stays at the queue head until a replica opens) instead of dropping or
    fast-failing; only a request no replica could EVER hold fails, at
    ``submit``;
  * per-replica config overrides let replicas run heterogeneous serving
    stacks (paged next to contiguous, different pools/policies) behind one
    front door;
  * ``sync=True`` steps every replica each router tick (the lock-step SPMD
    execution shape a device mesh would run); ``sync=False`` steps only
    replicas with work, skipping idle ones the way ``run`` skips idle gaps.

Cross-replica ``RouterStats`` aggregate the per-replica ``SchedulerStats``
(TTFT percentiles and per-class deadline attainment over the union of
finished requests, preemption/resume totals, per-replica utilization and
dispatch counts) into the one ``--report`` surface ``launch/serve.py``
prints.

Authoring a routing policy is the same three steps as a serving policy:
subclass ``RoutingPolicy``, ``@register_routing("name")``, pass the name
(``ServingConfig.router_policy``) or an instance to ``ReplicaRouter``.
Policies may be stateful (``round_robin`` keeps a cursor) and are
instantiated per router.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Sequence, TypeVar

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.policies import SloClasses
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           SchedulerLoad, SchedulerStats)
from repro_torch.serving.telemetry import ROUTER_SCOPE, Tracer, as_scope

T = TypeVar("T", bound=type)

_ROUTING: dict[str, type] = {}


def register_routing(name: str) -> Callable[[T], T]:
    """Class decorator: register a RoutingPolicy under ``name``."""
    def deco(cls: T) -> T:
        if name in _ROUTING:
            raise ValueError(
                f"routing policy {name!r} already registered "
                f"({_ROUTING[name].__name__}); unregister first to replace "
                f"it")
        cls.name = name
        _ROUTING[name] = cls
        return cls
    return deco


def get_routing(name: str) -> type:
    try:
        return _ROUTING[name]
    except KeyError:
        raise ValueError(f"unknown routing policy {name!r}; registered: "
                         f"{sorted(_ROUTING)}") from None


def list_routing() -> list[str]:
    return sorted(_ROUTING)


def unregister_routing(name: str) -> None:
    _ROUTING.pop(name, None)


def resolve_routing(spec, slo: SloClasses) -> "RoutingPolicy":
    """Registered name or RoutingPolicy instance -> instance."""
    if isinstance(spec, RoutingPolicy):
        return spec
    if isinstance(spec, str):
        return get_routing(spec)(slo)
    raise TypeError(f"routing policy must be a registered name or a "
                    f"RoutingPolicy instance, got {type(spec).__name__}")


# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Which replica an arrived request is dispatched to.

    ``select`` sees ``(replica index, SchedulerLoad)`` pairs for every
    replica that could *ever* hold the request (``accepts``-filtered, so a
    heterogeneous fleet's too-small replicas are already excluded) and
    returns the chosen index, or None to hold the request at the router
    (backpressure — it is offered again next tick, never dropped).  A
    policy must route when some replica is completely idle, or an
    all-idle router could spin forever.
    """

    name = "?"

    def __init__(self, slo: SloClasses):
        self.slo = slo

    def select(self, req: Request,
               candidates: Sequence[tuple[int, SchedulerLoad]]
               ) -> Optional[int]:
        raise NotImplementedError


@register_routing("round_robin")
class RoundRobinRouting(RoutingPolicy):
    """Cycle replicas in index order (skipping only replicas that can never
    hold the request).  Never backpressures: the chosen replica's own
    admission queue absorbs any wait — which makes the R = 1 router a
    bitwise-transparent shim over the bare scheduler."""

    def __init__(self, slo: SloClasses):
        super().__init__(slo)
        self._next = 0

    def select(self, req, candidates):
        idxs = [i for i, _ in candidates]
        later = [i for i in idxs if i >= self._next]
        pick = later[0] if later else idxs[0]
        self._next = pick + 1
        return pick


def _open_lanes(load: SchedulerLoad) -> int:
    """Lanes a newly dispatched request could actually claim: free lanes
    net of the replica's already-queued (and parked) backlog, which will
    consume them first.  This is what makes backpressure real — raw
    ``free_lanes`` stays positive while requests pile up in the replica's
    own admission queue."""
    return load.free_lanes - load.waiting - load.parked


def _capacity_key(load: SchedulerLoad) -> tuple:
    """Most free capacity first: open lanes + free pages (the load
    measure), free positions breaking ties.  Contiguous replicas report
    ``free_pages`` in one-position pages, so the sum stays monotone in
    both axes either way."""
    return (_open_lanes(load) + max(0, load.free_pages),
            load.free_positions)


@register_routing("least_loaded")
class LeastLoadedRouting(RoutingPolicy):
    """Late binding by free capacity: hold the request at the router until
    some replica has an open lane, then dispatch to the one with the most
    open lanes + free pages (ties: free positions, then lowest index)."""

    def select(self, req, candidates):
        open_ = [(i, ld) for i, ld in candidates if _open_lanes(ld) > 0]
        if not open_:
            return None
        return max(open_, key=lambda c: _capacity_key(c[1]) + (-c[0],))[0]


def _narrow_key(load: SchedulerLoad) -> tuple:
    """Width-class tiebreak for latency traffic: prefer the replica whose
    *narrowest* width class — the slots a rank-0 request would ride under
    the slo_tiered/load_adaptive width policies — has a free lane, then the
    one where that class's own headroom is largest.  Replicas without
    width classes report ``width_loads == ()`` and contribute a constant
    (0, 0), so a homogeneous fixed-N fleet orders exactly as before."""
    wl = getattr(load, "width_loads", ())
    if not wl:
        return (0, 0)
    return (int(wl[0]["free_lanes"] > 0), wl[0]["headroom"])


@register_routing("slo_headroom")
class SloHeadroomRouting(RoutingPolicy):
    """Latency traffic chases admission-horizon headroom: a top-rank
    (class-0) request goes to the open replica whose best admissible slot
    leaves the most positions before ``max_len`` — ``SchedulerLoad.headroom``,
    derived from the scheduler's exact ``_sim_ends`` ramp simulation — so
    it lands where its first token comes soonest and its budget provably
    fits.  Replicas running width classes (``width_set``) outrank on their
    narrowest class's availability first (``_narrow_key``): that is where
    a latency request would actually land.  Lower-rank traffic falls back
    to least-loaded."""

    def __init__(self, slo: SloClasses):
        super().__init__(slo)
        self._fallback = LeastLoadedRouting(slo)

    def select(self, req, candidates):
        if self.slo.rank(req.slo) != 0:
            return self._fallback.select(req, candidates)
        open_ = [(i, ld) for i, ld in candidates if _open_lanes(ld) > 0]
        if not open_:
            return None
        return max(open_, key=lambda c: _narrow_key(c[1]) + (c[1].headroom,)
                   + _capacity_key(c[1]) + (-c[0],))[0]


# ---------------------------------------------------------------------------
# Aggregated stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RouterStats:
    """Cross-replica aggregate of the per-replica ``SchedulerStats``.

    ``router_steps`` is the router clock — the wall-parallel step count
    (replicas step concurrently on their own devices in production, so
    completed tokens *per router step* is the scaling measure).
    ``decode_steps`` sums every replica's actual steps (total device work).
    TTFT percentiles and ``per_class`` deadline attainment are computed
    over the union of finished requests, in router-clock units."""
    replicas: int
    policy: str = ""
    sync: bool = False
    router_steps: int = 0
    idle_steps: int = 0
    requeues: int = 0                   # backpressure ticks: arrived head
                                        # held at the router (not dropped)
    dispatched: list = dataclasses.field(default_factory=list)  # per replica
    finished: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0               # Σ replica decode steps
    preemptions: int = 0
    resumes: int = 0
    ttft_p50: float = -1.0
    ttft_p99: float = -1.0
    per_class: dict = dataclasses.field(default_factory=dict)
    per_replica: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_step(self) -> float:
        """Completed tokens per router step — the replica-parallel
        throughput measure."""
        return self.generated_tokens / max(1, self.router_steps)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

class ReplicaRouter:
    """Front-end over R independent scheduler replicas.

    Construct from pre-built schedulers (maximum flexibility — each may
    wrap a differently configured engine) or via ``ReplicaRouter.build``
    (one shared param set, per-replica ``ServingConfig`` overrides).
    Defaults for ``policy``/``sync`` come from replica 0's
    ``cfg.serving.router_policy`` / ``router_sync``; SLO classes for the
    aggregated report resolve through replica 0's class table.
    """

    def __init__(self, schedulers: Sequence[ContinuousScheduler], *,
                 policy=None, sync: Optional[bool] = None, tracer=None):
        if not schedulers:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas: list[ContinuousScheduler] = list(schedulers)
        serving0 = self.replicas[0].engine.cfg.serving
        self.slo = self.replicas[0].slo
        self.policy = resolve_routing(
            serving0.router_policy if policy is None else policy, self.slo)
        self.sync = serving0.router_sync if sync is None else sync
        self.queue: collections.deque[Request] = collections.deque()
        self.requests: dict[int, Request] = {}
        self.t = 0
        self.stats = RouterStats(replicas=len(self.replicas),
                                 policy=self.policy.name, sync=self.sync,
                                 dispatched=[0] * len(self.replicas))
        # Telemetry: the router records under its own scope; each replica
        # scheduler gets scope i of the same Tracer.  Request spans open at
        # the router ("submit") and replicas only add lifecycle detail
        # (emit_submit off), and the router snaps the fleet-wide metric row
        # once per tick (replica owns_snapshots off).
        self.tracer = as_scope(tracer, ROUTER_SCOPE)
        if isinstance(tracer, Tracer):
            for i, sched in enumerate(self.replicas):
                scope = tracer.scope(i)
                scope.owns_snapshots = False
                scope.emit_submit = False
                sched.set_tracer(scope)

    @classmethod
    def build(cls, model, *, batch: int, max_len: int,
              replicas: Optional[int] = None, overrides: Optional[dict] = None,
              policy=None, sync: Optional[bool] = None,
              tracer=None) -> "ReplicaRouter":
        """R replicas over one ``Backbone``'s weights.  ``overrides`` maps a
        replica index to either a full ModelConfig or just a ServingConfig
        for that replica (heterogeneous fleets: paged next to contiguous,
        different pools/policies); that replica serves
        ``model.with_config`` of it.  Each replica's scheduler allocates its
        own cache or page pool."""
        cfg = model.cfg
        r = cfg.serving.replicas if replicas is None else replicas
        scheds = []
        for i in range(r):
            m = model
            ov = (overrides or {}).get(i)
            if ov is not None:
                m = model.with_config(
                    ov if isinstance(ov, ModelConfig)
                    else dataclasses.replace(cfg, serving=ov))
            scheds.append(ContinuousScheduler(
                Engine(m, batch=batch, max_len=max_len)))
        return cls(scheds, policy=policy, sync=sync, tracer=tracer)

    # -- queue ----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request at the router.  Fails fast only when NO replica
        could ever hold it; a merely-full fleet backpressures instead."""
        reasons = []
        for sched in self.replicas:
            reason = sched.accepts(req)
            if reason is None:
                if self.tracer.enabled:
                    self.tracer.event("submit", ts=max(self.t, req.arrival),
                                      rid=req.rid,
                                      prompt_len=len(req.prompt),
                                      max_new_tokens=req.max_new_tokens,
                                      slo=req.slo)
                self.requests[req.rid] = req
                self.queue.append(req)
                return
            reasons.append(reason)
        if self.tracer.enabled:
            self.tracer.event("reject", ts=max(self.t, req.arrival),
                              rid=req.rid, reason=reasons[0].split(";")[0])
        raise ValueError(
            f"request {req.rid} fits none of the {len(self.replicas)} "
            f"replicas: {reasons[0]}")

    def _dispatch(self) -> None:
        """Offer arrived requests (router-FIFO) to the routing policy with
        every admissible replica's load snapshot.  Stops at the first
        request the policy holds back — order is preserved and nothing is
        ever dropped; the held request is re-offered next tick."""
        while self.queue and self.queue[0].arrival <= self.t:
            req = self.queue[0]
            candidates = [(i, sched.load())
                          for i, sched in enumerate(self.replicas)
                          if sched.accepts(req) is None]
            pick = self.policy.select(req, candidates)
            if pick is None:
                self.stats.requeues += 1
                if self.tracer.enabled:
                    self.tracer.event("requeue", rid=req.rid,
                                      candidates=len(candidates))
                break
            if not 0 <= pick < len(self.replicas):
                raise ValueError(
                    f"routing policy {self.policy.name!r} chose replica "
                    f"{pick} of {len(self.replicas)}")
            self.queue.popleft()
            if self.tracer.enabled:
                self.tracer.event("dispatch", rid=req.rid, to_replica=pick)
            self.replicas[pick].submit(req)
            self.stats.dispatched[pick] += 1

    def _busy(self, sched: ContinuousScheduler) -> bool:
        return bool(sched._waiting() or sched.table.live_requests()
                    or len(sched.ledger))

    def _next_arrival(self) -> Optional[int]:
        return min((r.arrival for r in self.queue), default=None)

    # -- stepping -------------------------------------------------------------

    def step(self) -> None:
        """One router tick: dispatch arrived requests, then step replicas —
        all of them in ``sync`` mode (lock-step), only the busy ones
        otherwise.  Replica clocks are pinned to the router clock so
        arrival gating and TTFT are measured in router steps."""
        self.tracer.now = self.t
        self._dispatch()
        for sched in self.replicas:
            if self.sync or self._busy(sched):
                sched.t = self.t
                sched.step()
            else:
                sched.stats.idle_steps += 1
                sched.t = self.t + 1
        if self.tracer.enabled:
            # One fleet-wide metric row per router tick: the replica scopes
            # wrote their r{i}/ gauges during ``sched.step()`` above
            # (owns_snapshots off), the router adds its own and snaps.
            m = self.tracer.metrics
            m.gauge("queue_depth", len(self.queue))
            m.gauge("requeues", self.stats.requeues)
            self.tracer.snap(self.t)
        self.t += 1
        self.stats.router_steps += 1

    def run(self, requests: Optional[list[Request]] = None, *,
            max_steps: int = 100_000) -> RouterStats:
        """Drive a trace to completion across the fleet.  The clock jumps
        over fully idle gaps (no replica busy, next arrival in the future)
        exactly like ``ContinuousScheduler.run``."""
        for r in (requests or []):
            self.submit(r)
        while self.queue or any(self._busy(s) for s in self.replicas):
            if self.stats.router_steps >= max_steps:
                break
            if not any(self._busy(s) for s in self.replicas):
                nxt = self._next_arrival()
                if nxt is not None and nxt > self.t:
                    dt = nxt - self.t
                    self.stats.idle_steps += dt
                    for sched in self.replicas:
                        sched.stats.idle_steps += dt
                        sched.t = nxt
                    self.t = nxt
            self.step()
        return self.finalize()

    # -- aggregation ----------------------------------------------------------

    @property
    def finished(self) -> list[Request]:
        """Finished requests across every replica (rid order)."""
        out = [q for sched in self.replicas for q in sched.finished]
        return sorted(out, key=lambda q: q.rid)

    def finalize(self) -> RouterStats:
        """Aggregate per-replica SchedulerStats into the RouterStats the
        cross-replica ``--report`` prints.  Idempotent."""
        st = self.stats
        done = self.finished
        st.finished = len(done)
        st.generated_tokens = sum(s.stats.generated_tokens
                                  for s in self.replicas)
        st.decode_steps = sum(s.stats.decode_steps for s in self.replicas)
        st.preemptions = sum(s.stats.preemptions for s in self.replicas)
        st.resumes = sum(s.stats.resumes for s in self.replicas)
        agg = SchedulerStats()
        agg.finalize(done, self.slo)
        st.ttft_p50, st.ttft_p99 = agg.ttft_p50, agg.ttft_p99
        st.per_class = agg.per_class
        st.per_replica = []
        for i, sched in enumerate(self.replicas):
            s = sched.stats
            st.per_replica.append({
                "dispatched": st.dispatched[i],
                "finished": s.finished,
                "decode_steps": s.decode_steps,
                "idle_steps": s.idle_steps,
                "generated_tokens": s.generated_tokens,
                "mean_occupancy": round(s.mean_occupancy, 3),
                "peak_pages": s.peak_pages,
                "preemptions": s.preemptions,
                "resumes": s.resumes,
                "load": sched.load().as_dict(),
            })
        return st

"""Continuous-batching scheduler for multiplexed serving — the port of
``repro.serving.scheduler``.

The lock-step ``Engine.generate`` grid serves a fixed (B, N) wave: every
request must arrive together, run the same number of steps, and finish
together — one long generation holds B·N−1 streams hostage.  This module
adds stream-level granularity on top of the same decode step;
*policy* decisions (queue ordering, victim selection, token sampling) are
delegated to ``serving/policies.py`` so the scheduler itself only
orchestrates step execution:

  * requests queue up with their own arrival time, prompt, length budget,
    sampling parameters, and SLO class (``Request``; ``poisson_trace``
    replays a Poisson arrival process);
  * a ``SlotTable`` maps B backbone slots × N mux lanes to live request ids;
  * admission fills free lanes in the order the ``AdmissionPolicy`` dictates
    (``fifo`` | ``priority`` | ``slo``); a freshly admitted request's prompt
    *ramps* through the decode path muxed alongside the slot's other lanes,
    which keep decoding undisturbed;
  * retirement (EOS or length budget) frees a lane immediately; when a
    slot's lanes have all retired, the allocator rewinds just that slot to
    the prefix-primed cache;
  * preempt-and-swap (``preempt=True``): when the grid is full (or every
    free lane refuses the head request) and the head request outranks a
    live slot under the ``EvictionPolicy``, that slot's lanes park together
    in the ``SwapLedger`` — under paging the block-table row detaches with
    its pages resident (a host-side row swap); contiguous mode snapshots
    the slot region — and the freed slot admits the head request at
    ``prefix_len``.  Parked groups resume into the next empty slot with
    cache and positions restored exactly, so a victim's continuation
    tokens are bitwise-identical to an un-preempted run and no prompt is
    ever re-prefilled.

Admission horizons are *exact*: ``_slot_horizons`` simulates the slot's
remaining chunked ramp schedule (per-lane prompt remainders and generation
budgets, the same arithmetic the step loop executes), so a prompt that
rides entirely inside an in-flight ramp costs its co-lanes nothing and
tight pools admit as early as the cache truly allows.  With
``prefill_chunk == 1`` the simulation collapses to the closed form
``pos + Lp + gen`` — the original admission math, bit-for-bit.

Cache layout is pluggable (``cfg.serving.paged``): contiguous
(``KVSlotAllocator``, per-slot ``max_len`` regions) or paged
(``PagedKVSlotAllocator``, block tables over a shared pool; admission
checks free pages, with parked groups' worst-case footprints reserved so
resumption never deadlocks on the pool).

Adaptive multiplexing width (``cfg.serving.width_set``): the B slots are
partitioned into *width classes*, each served by an engine variant
at its own mux width (``Engine.variant``: narrowed mux/demux params and
index embeds, shared backbone weights, per-class KV/page templates and —
under paging — per-class page pools).  A ``WidthPolicy``
(``serving/policies.py``: static | slo_tiered | load_adaptive) decides at
admission which class a request rides: latency-SLO traffic lands on low-N
slots (shorter mixed stream, higher per-stream fidelity, faster TTFT),
bulk traffic on high-N slots for raw tok/step.  The swap unit stays the
slot, within its class — a parked group resumes only into its own class
(the cache shape is class-specific).  An empty ``width_set`` (or a
singleton at the native width) is one class on the engine itself:
bit-for-bit the fixed-N scheduler.

Prefix protocol note: for causal backbones the demux-prefix hidden states
(``index_embeds``) and prefix K/V depend only on the prefix itself, so the
scheduler computes them once (``Engine.prime``) and reuses them across every
slot recycle — admission never re-runs a prefill.  For bidirectional
backbones (T-MUX) this reuse is the same approximation the lock-step decode
path already makes.

The port brings each step's logits to the host once per width class and
converts them to float32 numpy there; sampling and every scheduling
decision stay on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.serving import policies as serving_policies
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator, pages_for
from repro_torch.serving.policies import SloClasses
from repro_torch.serving.slots import FREE, ParkedGroup, SlotTable, SwapLedger
from repro_torch.serving.telemetry import as_scope, kblock_stats


def _host_logits(logits) -> np.ndarray:
    """One device-to-host copy of a step's logits, then float32 numpy (a
    bfloat16 CUDA tensor has no numpy view)."""
    return logits.cpu().float().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (Lp,) int32 prompt tokens
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: int = 0              # scheduler-clock step of arrival
    temperature: float = 0.0      # 0 = greedy (bit-for-bit default path)
    seed: Optional[int] = None    # per-request sampling seed (default: rid)
    priority: int = 0             # higher admits first under policy="priority"
    slo: str = ""                 # SLO class name (policy="slo"); unknown or
                                  # empty resolves to the lowest class
    # runtime state (owned by the scheduler)
    admitted_step: int = -1
    finished_step: int = -1
    ttft: int = -1                # time to first token: decode steps between
                                  # arrival and the first generated token
                                  # (0 = first token the step it arrived);
                                  # -1 before the first token lands.
                                  # Queueing delay included — the latency an
                                  # SLO deadline is written against.
    preempted: int = 0            # times this request's slot was parked
    width: int = 0                # mux width of the class it was admitted
                                  # into (0 until admission)
    output: list = dataclasses.field(default_factory=list)
    fed: int = 0                  # prompt tokens consumed so far (ramp cursor)
    rng: Any = None               # lazily built per-request sampler

    @property
    def ramping(self) -> bool:
        return self.fed < len(self.prompt)

    @property
    def ramp_latency(self) -> int:
        """Decode steps from admission to the first generated token
        (inclusive); -1 before the first token lands.  ~ceil(Lp/chunk)
        under chunked prefill, Lp under the classic one-token ramp."""
        if self.ttft < 0 or self.admitted_step < 0:
            return -1
        return self.arrival + self.ttft - self.admitted_step + 1

    @property
    def done(self) -> bool:
        return self.finished_step >= 0

    def fresh(self) -> "Request":
        """Copy with runtime state reset, so a trace can be replayed by
        several engines/schedulers."""
        return dataclasses.replace(self, output=[], fed=0, admitted_step=-1,
                                   finished_step=-1, ttft=-1,
                                   preempted=0, width=0, rng=None)


def poisson_trace(n_requests: int, *, rate: float, prompt_len: int,
                  gen_len: int, vocab: int, max_total: int = 0,
                  eos_id: Optional[int] = None, seed: int = 0,
                  slo_mix: float = 0.0,
                  slo_names: tuple = ("latency", "batch")) -> list[Request]:
    """Poisson arrival process with mixed prompt/generation lengths.

    ``rate``: mean arrivals per decode step.  Prompt lengths are uniform in
    [1, 2·prompt_len]; generation budgets are geometric with mean
    ``gen_len`` (the long tail is what static batching chokes on).
    ``max_total`` clips prompt+gen so every request fits the cache.
    ``slo_mix`` > 0 tags that fraction of requests with the first SLO class
    in ``slo_names`` (interactive latency traffic) and the rest with the
    second (throughput batch) — the two-class workload preempt-and-swap
    exists for.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / rate, n_requests)))
    reqs = []
    for i in range(n_requests):
        lp = int(rng.integers(1, 2 * prompt_len + 1))
        gen = int(min(rng.geometric(1.0 / gen_len), 4 * gen_len))
        if max_total:
            lp = min(lp, max_total - 1)
            gen = max(1, min(gen, max_total - lp))
        slo = ""
        if slo_mix > 0.0:
            slo = slo_names[0] if rng.random() < slo_mix else slo_names[1]
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, lp).astype(np.int32),
            max_new_tokens=gen, eos_id=eos_id, arrival=int(arrivals[i]),
            slo=slo))
    return reqs


def static_batch_steps(requests: list[Request], n_slots: int,
                       n_lanes: int) -> int:
    """Decode-step count of the lock-step baseline on the same trace.

    The static engine groups requests in arrival order into full (B·N)-lane
    waves; each wave prefills together (prompt cost excluded — one fused
    prefill call, a handicap in the static engine's favour) and decodes
    until its *longest* generation finishes.  Head-of-line blocking is the
    sum of per-wave maxima."""
    lanes = n_slots * n_lanes
    total = 0
    for g in range(0, len(requests), lanes):
        total += max(r.max_new_tokens for r in requests[g:g + lanes])
    return total


@dataclasses.dataclass(frozen=True)
class SchedulerLoad:
    """Point-in-time load/headroom snapshot of one ``ContinuousScheduler``.

    The public probe the replica router (``serving/router.py``) dispatches
    against — free lanes, free pages, and admission-horizon headroom in one
    read — so nothing outside the scheduler reaches into ``allocator.table``
    or ``lane_end``.  Horizons come from the exact ``_sim_ends`` ramp
    simulation, the same arithmetic admission itself uses.

    Paged-only fields (``usable_pages``/``pages_in_use``) are 0 under the
    contiguous allocator; ``free_pages`` then equals ``free_positions``
    (one-position pages).  ``free_pages`` is *admission* headroom — usable
    pages minus every live slot's worst-case horizon footprint and the swap
    ledger's parked reservations — not the raw free list, so a router
    reading it sees what a new request could actually claim.
    """
    free_lanes: int        # unoccupied (slot, lane) cells
    total_lanes: int       # n_slots * n_lanes
    free_slots: int        # fully empty slots (admit at prefix_len)
    waiting: int           # requests queued at this scheduler
    parked: int            # groups in the swap ledger
    free_pages: int        # pages a new request could claim (net of
                           # horizons + parked reservations); may be < 0
                           # transiently when horizons tighten mid-round
    usable_pages: int      # paged: pool_pages - trash; contiguous: 0
    pages_in_use: int      # paged: pages actually mapped; contiguous: 0
    free_positions: int    # free_pages in positions (page_size multiple)
    headroom: int          # best single-request admission headroom in
                           # positions: max over slots with a free lane of
                           # max_len - slot horizon (0 when no lane is free)
    width_loads: tuple = ()  # per-width-class load dicts (ascending width)
                             # when width_set partitions the slots; () for a
                             # single class, so every fixed-N consumer —
                             # router keys, load_adaptive fallbacks, bench
                             # payloads — sees exactly the legacy snapshot

    @property
    def lane_utilization(self) -> float:
        return 1.0 - self.free_lanes / max(1, self.total_lanes)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SchedulerStats:
    decode_steps: int = 0
    idle_steps: int = 0
    admitted: int = 0
    finished: int = 0
    slot_resets: int = 0
    generated_tokens: int = 0
    occupancy_sum: float = 0.0          # Σ per-step lane occupancy
    slot_active_steps: Optional[np.ndarray] = None  # (B,) useful-work steps
    peak_pages: int = 0                 # paged mode: pool high-water mark
    preemptions: int = 0                # slots parked into the swap ledger
    resumes: int = 0                    # parked groups restored
    ttft_p50: float = -1.0              # time-to-first-token percentiles
    ttft_p99: float = -1.0              #   (filled by ``run``)
    per_class: dict = dataclasses.field(default_factory=dict)
    per_width: dict = dataclasses.field(default_factory=dict)
    final_load: Optional[SchedulerLoad] = None  # load snapshot after ``run``

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(1, self.decode_steps)

    def finalize(self, finished: list[Request], slo: SloClasses) -> None:
        """Fill TTFT percentiles and per-SLO-class completion stats from
        the finished requests (idempotent; called at the end of ``run``)."""
        ttfts = [r.ttft for r in finished if r.ttft >= 0]
        if ttfts:
            self.ttft_p50 = float(np.percentile(ttfts, 50))
            self.ttft_p99 = float(np.percentile(ttfts, 99))
        self.per_class = {}
        for name in slo.names:
            rs = [r for r in finished if slo.resolve(r.slo) == name]
            if not rs:
                continue
            tt = [r.ttft for r in rs if r.ttft >= 0]
            deadline = slo.deadline(name)
            self.per_class[name] = {
                "finished": len(rs),
                "ttft_p50": float(np.percentile(tt, 50)) if tt else -1.0,
                "ttft_p99": float(np.percentile(tt, 99)) if tt else -1.0,
                "ttft_deadline": deadline,
                "deadline_hit_rate": (sum(t <= deadline for t in tt)
                                      / len(tt)) if tt else 0.0,
                "preempted": sum(r.preempted for r in rs),
            }
        self.per_width = {}
        for w in sorted({r.width for r in finished if r.width > 0}):
            rs = [r for r in finished if r.width == w]
            tt = [r.ttft for r in rs if r.ttft >= 0]
            self.per_width[w] = {
                "count": len(rs),
                "tokens": sum(len(r.output) for r in rs),
                "ttft_mean": float(np.mean(tt)) if tt else -1.0,
                "ttft_p50": float(np.percentile(tt, 50)) if tt else -1.0,
                "ttft_p99": float(np.percentile(tt, 99)) if tt else -1.0,
                "preempted": sum(r.preempted for r in rs),
            }


@dataclasses.dataclass
class WidthClass:
    """One width class of the slot grid: a contiguous block of slots served
    by an engine variant at ``width`` mux lanes.

    The class owns everything whose shape depends on the width — the engine
    variant (narrowed mux/demux params over shared backbone weights), the
    primed prefix state, and the KV allocator (per-class page pool under
    paging: block shapes differ across widths, so pages cannot be shared).
    Slot indices are global; allocator calls translate by ``start``."""
    index: int              # position in the ascending width_set
    width: int              # mux lanes per slot in this class
    start: int              # first global slot of the class block
    n_slots: int            # slots in the class block
    engine: Any             # Engine variant (the native engine itself when
                            # width == cfg.mux.n and the class spans B)
    allocator: Any          # per-class KV/page allocator (local slot ids)
    index_embeds: Any       # primed demux-prefix hiddens at this width
    mux_active: bool
    prefix_len: int         # this width's demux-prefix length
    max_len: int            # engine.max_len of the variant

    @property
    def slots(self) -> range:
        return range(self.start, self.start + self.n_slots)

    def local(self, slot: int) -> int:
        return slot - self.start


class ContinuousScheduler:
    """Continuous batching over an ``Engine``: stream-level admission,
    retirement, and preempt-and-swap on a B-slot × N-lane grid sharing one
    decode step.  Queue ordering, victim selection, and sampling are
    pluggable (``serving/policies.py``); defaults come from
    ``cfg.serving`` so a config fully describes the serving behaviour."""

    def __init__(self, engine: Engine, *, policy=None, preempt=None,
                 eviction=None, sampling=None, width_policy=None,
                 tracer=None):
        self.engine = engine
        cfg = engine.cfg
        self.slo = SloClasses(cfg.serving.slo_classes)
        self.admission = serving_policies.resolve(
            "admission", cfg.serving.policy if policy is None else policy,
            self.slo)
        self.policy = self.admission.name
        self.preempt = cfg.serving.preempt if preempt is None else preempt
        self.eviction = serving_policies.resolve(
            "eviction",
            self.admission.default_eviction if eviction is None else eviction,
            self.slo)
        if self.preempt and isinstance(self.eviction,
                                       serving_policies.NoEviction):
            raise ValueError(
                f"preempt=True needs a ranked eviction policy, but "
                f"admission policy {self.policy!r} pairs with 'none'; use "
                f"policy='slo'/'priority' or pass eviction= explicitly")
        self.sampling = serving_policies.resolve(
            "sampling", "lane" if sampling is None else sampling, self.slo)
        self.width = serving_policies.resolve(
            "width",
            cfg.serving.width_policy if width_policy is None else width_policy,
            self.slo)

        self.n_slots = engine.batch
        self.prefix_len = cfg.mux.prefix_len
        self.paged = cfg.serving.paged
        # Chunked prefill: an admitted prompt feeds up to ``chunk`` tokens
        # per decode step instead of one.  chunk == 1 keeps the legacy
        # single-token step bit-for-bit.
        self.chunk = max(1, cfg.serving.prefill_chunk)

        # Width classes: partition the B slots across cfg.serving.width_set
        # (ascending; evenly, remainder to the widest — lanes are the
        # scarce resource).  An empty width_set is one class at the native
        # width on the engine itself — the fixed-N scheduler, bit-for-bit.
        native = cfg.mux.n if cfg.mux.active else 1
        self.widths = tuple(cfg.serving.width_set) or (native,)
        k = len(self.widths)
        if self.n_slots < k:
            raise ValueError(
                f"width_set {self.widths} needs at least {k} slots but the "
                f"engine batch is {self.n_slots}; shrink width_set or raise "
                f"batch")
        counts = [self.n_slots // k] * k
        for i in range(self.n_slots % k):
            counts[k - 1 - i] += 1
        self.n_lanes = max(self.widths)

        # Paged: prime against a prefix-sized cache (no dense (B, max_len)
        # transient); the allocator imports the prefix pages from it.  The
        # contiguous allocator needs the full-width template for its masked
        # slot resets, so it keeps the full prime.
        engines = [engine.variant(w, c) for w, c in zip(self.widths, counts)]
        pools = self._split_pool(cfg, engines, counts) \
            if self.paged else [0] * k
        self.classes: list[WidthClass] = []
        start = 0
        for i, (w, veng) in enumerate(zip(self.widths, engines)):
            primed = veng.prime(compact=self.paged)
            if self.paged:
                alloc = PagedKVSlotAllocator(
                    veng.cfg, counts[i], veng.max_len, template=primed.cache,
                    pool_pages=pools[i])
            else:
                alloc = KVSlotAllocator(
                    veng.cfg, counts[i], veng.max_len, template=primed.cache)
            self.classes.append(WidthClass(
                index=i, width=w, start=start, n_slots=counts[i],
                engine=veng, allocator=alloc,
                index_embeds=primed.index_embeds,
                mux_active=veng.cfg.mux.active,
                prefix_len=veng.cfg.mux.prefix_len, max_len=veng.max_len))
            start += counts[i]
        self.multiclass = k > 1
        # Legacy accessors: the single-class scheduler is the fixed-N one,
        # and external probes (tests, benches) reach these directly.
        self.allocator = self.classes[0].allocator
        self.index_embeds = self.classes[0].index_embeds
        # slot -> class index / class prefix length, for O(1) dispatch.
        self.cls_of = np.concatenate(
            [np.full(c.n_slots, c.index, np.int32) for c in self.classes])
        self.prefix_by_slot = np.concatenate(
            [np.full(c.n_slots, c.prefix_len, np.int32)
             for c in self.classes])

        self.table = SlotTable(
            self.n_slots, self.n_lanes,
            lane_counts=None if not self.multiclass else np.concatenate(
                [np.full(c.n_slots, c.width, np.int64)
                 for c in self.classes]))
        self.ledger = SwapLedger()
        self.pos = self.prefix_by_slot.astype(np.int32).copy()
        # Preemption hysteresis: the step a slot last admitted or resumed a
        # request.  With ``min_residency_steps`` K > 0 the eviction policy
        # never parks a slot younger than K steps — a flapping latency
        # class cannot churn the same batch victim every step.
        self.min_residency = cfg.serving.min_residency_steps
        # Per-request preemption cap: a request parked this many times is
        # eviction-immune (its slot drops out of _park_candidates).
        self.max_preemptions = cfg.serving.max_preemptions
        self.slot_since = np.full(self.n_slots, -(1 << 60), np.int64)
        # Per-lane end-position horizon (exclusive; -1 = free lane),
        # refreshed from the exact ramp simulation each admission round:
        # the paged admission check sizes every slot's worst-case footprint
        # in pages against the pool.
        self.lane_end = np.full((self.n_slots, self.n_lanes), -1, np.int64)
        self.requests: dict[int, Request] = {}
        self.finished: list[Request] = []
        # Per-width running TTFT sums (first tokens seen so far), feeding
        # the width-class telemetry gauges; multi-class only.
        self._width_ttft: dict[int, list] = {}
        self.t = 0                       # scheduler clock (steps)
        self.stats = SchedulerStats(
            slot_active_steps=np.zeros(self.n_slots, np.int64))
        self.set_tracer(tracer)

    @staticmethod
    def _split_pool(cfg, engines, counts) -> list[int]:
        """Per-class page-pool sizes.  ``serving.pool_pages == 0`` lets each
        allocator take its dense default (every slot fully resident) by
        passing 0 through.  An explicit pool splits proportionally to each
        class's dense footprint (slots × pages per full slot), remainder to
        the widest, floored at each class's allocator minimum (prefix pages
        per slot + working page + trash page)."""
        total = cfg.serving.pool_pages
        k = len(engines)
        if not total or k == 1:
            return [total] * k
        ps = cfg.serving.page_size
        dense = [c * pages_for(e.max_len, ps) + 1
                 for e, c in zip(engines, counts)]
        mins = [max(2, c * pages_for(e.cfg.mux.prefix_len, ps) + 2)
                for e, c in zip(engines, counts)]
        weight = sum(dense)
        pools = [min(d, total * d // weight) for d in dense]
        pools[-1] += min(total, weight) - sum(pools)
        pools = [max(p, m) for p, m in zip(pools, mins)]
        if sum(pools) > total:
            raise ValueError(
                f"serving.pool_pages={total} cannot cover width_set "
                f"{tuple(e.cfg.mux.n for e in engines)}: per-class minimums "
                f"are {mins} pages ({sum(mins)} total); raise pool_pages or "
                f"drop a width class")
        return pools

    def _cls(self, slot: int) -> WidthClass:
        return self.classes[int(self.cls_of[slot])]

    def set_tracer(self, tracer) -> None:
        """Attach a telemetry recorder (``serving/telemetry.py``) to this
        scheduler and everything it owns — engines, allocators, swap
        ledger.  ``tracer`` may be a ``Tracer`` (bound to replica scope 0),
        an existing scope (a router hands each replica its own), or None
        (the ``NULL_TRACER`` no-op default: the untraced path is
        untouched)."""
        self.tracer = as_scope(tracer)
        self.engine.tracer = self.tracer
        for c in self.classes:
            c.engine.tracer = self.tracer
            c.allocator.tracer = self.tracer
        self.ledger.tracer = self.tracer

    # -- queue (delegated to the admission policy) -----------------------------

    def accepts(self, req: Request) -> Optional[str]:
        """None when this scheduler could ever hold ``req``, else the
        refusal reason — the submit-time fast-fail as a non-raising probe,
        so a router can test heterogeneous replicas before dispatching.
        With width classes, acceptance anywhere suffices — the width policy
        only orders classes, it never strands an admissible request."""
        reasons = [self._class_accepts(req, c) for c in self.classes]
        if any(r is None for r in reasons):
            return None
        if len(reasons) == 1:
            return reasons[0]
        return (f"request {req.rid} fits no width class: "
                + " | ".join(f"n={c.width}: {r}"
                             for c, r in zip(self.classes, reasons)))

    def _class_accepts(self, req: Request, c: WidthClass) -> Optional[str]:
        need = c.prefix_len + len(req.prompt) + req.max_new_tokens
        if need > c.max_len:
            hint = ("raise Engine max_len — under paging the table width is "
                    "cheap, memory is pooled per page"
                    if self.paged else
                    "raise Engine max_len or clip the trace (paged "
                    "attention — cfg.serving.paged — is the real fix)")
            return (f"request {req.rid} needs {need} positions but the cache "
                    f"holds {c.max_len}; {hint}")
        if self.paged:
            # A request that cannot fit even with every other slot drained
            # to its prefix pages would starve in the queue forever.
            alloc = c.allocator
            floor = ((c.n_slots - 1) * alloc.n_prefix_pages
                     + pages_for(need, alloc.page_size))
            if floor > alloc.table.usable_pages:
                return (
                    f"request {req.rid} needs "
                    f"{pages_for(need, alloc.page_size)} "
                    f"pages but the pool can never free more than "
                    f"{alloc.table.usable_pages - (c.n_slots - 1) * alloc.n_prefix_pages}"
                    f"; raise serving.pool_pages")
        return None

    def submit(self, req: Request) -> None:
        reason = self.accepts(req)
        if reason is not None:
            if self.tracer.enabled:
                self.tracer.event("reject", ts=max(self.t, req.arrival),
                                  rid=req.rid, reason=reason.split(";")[0])
            raise ValueError(reason)
        if self.tracer.enabled and self.tracer.emit_submit:
            # Lifecycle span opens at arrival (requests are usually
            # submitted up front with future arrival times), never before
            # the clock a late submit happens at.
            self.tracer.event("submit", ts=max(self.t, req.arrival),
                              rid=req.rid, prompt_len=len(req.prompt),
                              max_new_tokens=req.max_new_tokens,
                              slo=req.slo)
        self.requests[req.rid] = req
        self.admission.push(req)

    def _peek(self) -> Optional[Request]:
        return self.admission.peek(self.t)

    def _pop(self) -> Request:
        return self.admission.pop(self.t)

    def _waiting(self) -> int:
        return self.admission.waiting()

    def _next_arrival(self) -> Optional[int]:
        return self.admission.next_arrival(self.t)

    # -- exact horizon accounting ----------------------------------------------

    def _lane_state(self, req: Request) -> tuple[int, int]:
        """(prompt tokens left to feed, output feeds left) — the output
        count includes one virtual position for the final sampled token
        that is never fed back, matching the classic ``pos + Lp + gen``
        reservation."""
        rp = len(req.prompt) - req.fed
        k = len(req.output)
        rf = req.max_new_tokens - k + (1 if k else 0)
        return rp, rf

    def _sim_ends(self, pos: int, states: list[list]) -> list[int]:
        """Exact per-lane end horizons (exclusive): replay the slot's
        remaining chunked schedule — each ramping lane feeds up to
        ``chunk`` prompt tokens per step, decoding lanes feed one, and the
        slot advances by the largest take — with no further admissions.
        EOS may retire lanes earlier, so these are tight upper bounds.
        ``chunk == 1`` short-circuits to the closed form the original
        scheduler used (every lane advances one position per step)."""
        if self.chunk == 1:
            return [pos + rp + rf for rp, rf in states]
        C = self.chunk
        st = [list(s) for s in states]
        ends = [pos] * len(st)
        p = pos
        while True:
            if all(rp <= 0 for rp, _ in st):
                # No ramps left: every live lane advances one position per
                # step, so the closed form finishes the simulation — the
                # steady-state decode path never loops over its remaining
                # generation budget.
                for i, (_, rf) in enumerate(st):
                    if rf > 0:
                        ends[i] = p + rf
                return ends
            takes = [min(C, rp) if rp > 0 else (1 if rf > 0 else 0)
                     for rp, rf in st]
            valid = max(takes, default=0)
            if valid == 0:
                return ends
            for i, take in enumerate(takes):
                if take == 0:
                    continue
                if st[i][0] > 0:
                    st[i][0] -= take
                else:
                    st[i][1] -= 1
                ends[i] = p + take
            p += valid

    def _slot_horizons(self, s: int, pos: int,
                       extra: Optional[tuple[int, int]] = None
                       ) -> tuple[list[int], list[int], list[int]]:
        """Exact end horizons for slot ``s`` decoding from ``pos``, with an
        optional candidate lane (``extra`` = its (rp, rf) state) appended.
        Returns (lane indices, their ends, candidate-included ends)."""
        states, idx = [], []
        for l in range(self.n_lanes):
            rid = int(self.table.grid[s, l])
            if rid < 0:
                continue
            states.append(list(self._lane_state(self.requests[rid])))
            idx.append(l)
        if extra is not None:
            states.append(list(extra))
        ends = self._sim_ends(pos, states)
        return idx, ends[:len(idx)], ends

    def _refresh_horizons(self) -> None:
        """Re-derive every live lane's exact end horizon from its current
        ramp/decode state — tightens after EOS retirements and keeps the
        paged pool accounting honest between admission rounds."""
        for s in range(self.n_slots):
            if self.table.slot_empty(s):
                continue
            idx, ends, _ = self._slot_horizons(s, int(self.pos[s]))
            for l, e in zip(idx, ends):
                self.lane_end[s, l] = e

    def _fits_pages(self, c: WidthClass, fresh: set, overrides: dict,
                    extra_reserved: int = 0) -> bool:
        """Paged admission: would every slot's worst-case footprint — plus
        the swap ledger's parked reservations — still fit the class's pool?
        ``overrides`` maps (global) slot -> hypothetical end horizon (a
        candidate admission or a preemption's fresh occupant); slots
        recycled this round (``fresh``) count their prefix pages only.
        Parked groups reserve their full horizon, so resumption never waits
        on pages.  Pools are per width class, so only the class's own slots
        and parked groups count against it."""
        alloc = c.allocator
        total = self.ledger.reserved_pages(c.index) + extra_reserved
        for s in c.slots:
            allocated = alloc.n_prefix_pages if s in fresh \
                else int(alloc.table.n_allocated[c.local(s)])
            horizon = overrides.get(s, int(self.lane_end[s].max()))
            need = allocated
            if horizon > 0:
                need = max(need, pages_for(horizon, alloc.page_size))
            total += need
        return total <= alloc.table.usable_pages

    # -- load probe ------------------------------------------------------------

    def load(self) -> SchedulerLoad:
        """Snapshot free lanes / free pages / admission-horizon headroom.

        Horizons are refreshed through the exact ramp simulation first, so
        the snapshot agrees with what the next admission round would see.
        ``benchmarks`` and ``launch/serve.py`` read pool occupancy from
        here instead of recomputing it from ``allocator.table``."""
        self._refresh_horizons()
        grid = self.table.grid
        total_lanes = sum(c.n_slots * c.width for c in self.classes)
        free_lanes = int((grid == FREE).sum())
        free_slots = sum(self.table.slot_empty(s)
                         for s in range(self.n_slots))
        headroom = 0
        free_pages = usable = in_use = 0
        free_positions = 0
        width_loads = []
        for c in self.classes:
            # Best single-request headroom: an empty slot admits at
            # prefix_len; a live slot with a free lane admits in-stream at
            # its horizon.  Slots with no free lane cannot admit at all.
            c_headroom = 0
            slot_room = []
            for s in c.slots:
                if self.table.slot_empty(s):
                    room = c.max_len - c.prefix_len
                    has_lane = True
                else:
                    room = c.max_len - int(self.lane_end[s].max())
                    has_lane = bool((grid[s] == FREE).any())
                slot_room.append(max(0, room))
                if has_lane:
                    c_headroom = max(c_headroom, max(0, room))
            if self.paged:
                alloc = c.allocator
                committed = self.ledger.reserved_pages(c.index)
                for s in c.slots:
                    allocated = int(alloc.table.n_allocated[c.local(s)])
                    horizon = int(self.lane_end[s].max())
                    need = allocated
                    if horizon > 0:
                        need = max(need, pages_for(horizon, alloc.page_size))
                    committed += need
                c_free_pages = alloc.table.usable_pages - committed
                c_free_positions = max(0, c_free_pages) * alloc.page_size
                usable += alloc.table.usable_pages
                in_use += alloc.table.pages_in_use
                c_headroom = min(c_headroom, c_free_positions)
            else:
                c_free_positions = sum(slot_room)
                c_free_pages = c_free_positions
            free_pages += c_free_pages
            free_positions += c_free_positions
            headroom = max(headroom, c_headroom)
            if self.multiclass:
                width_loads.append({
                    "width": c.width,
                    "total_lanes": c.n_slots * c.width,
                    "free_lanes": int((grid[c.start:c.start + c.n_slots]
                                       == FREE).sum()),
                    "free_slots": sum(self.table.slot_empty(s)
                                      for s in c.slots),
                    "parked": sum(g.wclass == c.index for g in self.ledger),
                    "free_pages": c_free_pages,
                    "headroom": c_headroom,
                })
        return SchedulerLoad(
            free_lanes=free_lanes, total_lanes=total_lanes,
            free_slots=free_slots, waiting=self._waiting(),
            parked=len(self.ledger), free_pages=free_pages,
            usable_pages=usable, pages_in_use=in_use,
            free_positions=free_positions, headroom=headroom,
            width_loads=tuple(width_loads))

    # -- admission -------------------------------------------------------------

    def _admit(self) -> None:
        """Resume parked groups, fill free lanes from the queue, and — when
        the head request outranks a live slot — preempt.  Empty slots whose
        position has drifted past ``prefix_len`` are rewound via one
        batched cache reset before re-occupying."""
        to_reset = np.zeros(self.n_slots, bool)
        target: dict[int, int] = {}      # slot -> admission position
        fresh: set[int] = set()          # slots recycled this round
        self._refresh_horizons()
        self._resume_parked(target)
        # One width-policy load snapshot per admission round (multi-class
        # only): the policy orders classes, it does not need mid-round
        # precision, and the probe is not free.
        wload = self.load() if self.multiclass else None
        n_admitted = 0
        while True:
            n_admitted += self._fill_free_lanes(target, fresh, to_reset,
                                                wload)
            if not (self.preempt and self._preempt_one(target, fresh,
                                                       to_reset, wload)):
                break
        if to_reset.any():
            for c in self.classes:
                sel = to_reset[c.start:c.start + c.n_slots]
                if sel.any():
                    c.allocator.reset_slots(sel)
            self.pos[to_reset] = self.prefix_by_slot[to_reset]
            self.stats.slot_resets += int(to_reset.sum())
        self.stats.admitted += n_admitted

    def _class_order(self, req: Request, wload) -> list[int]:
        """Class indices to try for ``req``, best first, from the width
        policy — sanitised so a custom policy returning junk degrades to
        trying every class rather than stranding the request."""
        if not self.multiclass:
            return [0]
        k = len(self.classes)
        order = [i for i in self.width.order(req, self.widths, wload)
                 if isinstance(i, int) and 0 <= i < k]
        seen = set()
        order = [i for i in order if not (i in seen or seen.add(i))]
        return order + [i for i in range(k) if i not in seen]

    def _fill_free_lanes(self, target: dict, fresh: set,
                         to_reset: np.ndarray, wload=None) -> int:
        """Offer free lanes to the admission policy's head request: an
        empty slot rewinds to the primed prefix; a live slot admits
        in-stream at its current position (the prompt ramps during
        decode).  A lane is granted only if the exact horizons of every
        lane it would share the slot with stay inside the class's cache
        (and, when paged, its pool).

        The head request scans classes in the width policy's order; within
        a class, free lanes are consumed by a persistent slot-major cursor
        — a lane one request refused is never re-offered this round, which
        keeps the round linear in lanes and, with a single class, replays
        the legacy lane-major loop decision-for-decision."""
        n = 0
        lanes = {c.index: (sl for sl in self.table.free_lanes()
                           if self.cls_of[sl[0]] == c.index)
                 for c in self.classes}
        while True:
            req = self._peek()
            if req is None:
                break
            placed = False
            for ci in self._class_order(req, wload):
                c = self.classes[ci]
                for (s, l) in lanes[ci]:
                    if s not in target:
                        if self.table.slot_empty(s):
                            target[s] = c.prefix_len
                            fresh.add(s)
                        else:
                            target[s] = int(self.pos[s])
                    pos = target[s]
                    idx, ends, all_ends = self._slot_horizons(
                        s, pos, extra=(len(req.prompt), req.max_new_tokens))
                    horizon = max(all_ends)
                    if horizon > c.max_len:
                        continue  # slot too deep for this request
                    if self.paged and not self._fits_pages(c, fresh,
                                                           {s: horizon}):
                        continue  # pool too full for this slot
                    self._pop()
                    if pos != int(self.pos[s]):
                        to_reset[s] = True
                    self.table.occupy(s, l, req.rid)
                    self.slot_since[s] = self.t
                    # Exact bookkeeping for every lane the admission
                    # touches: the co-lanes' ends move only as far as the
                    # simulation says (zero when an in-flight ramp already
                    # covers the new prompt).
                    for li, e in zip(idx, ends):
                        self.lane_end[s, li] = e
                    self.lane_end[s, l] = all_ends[-1]
                    req.admitted_step = self.t
                    req.width = c.width
                    if self.tracer.enabled:
                        self.tracer.event("admit", rid=req.rid, slot=s,
                                          lane=l, pos=pos,
                                          horizon=int(all_ends[-1]))
                    n += 1
                    placed = True
                    break
                if placed:
                    break
            if not placed:
                break
        return n

    # -- preempt-and-swap ------------------------------------------------------

    def _park_candidates(self, target: dict, c: WidthClass) -> list:
        """Slots of class ``c`` eligible to park: live lanes, untouched
        this admission round (no planned admissions or resumes to unwind),
        resident at least ``min_residency_steps`` since their last
        admission or resume (hysteresis: a freshly resumed victim is
        shielded, so a flapping outranking class cannot churn it), and —
        under ``max_preemptions`` K — holding no request already parked K
        times (a bounced request becomes eviction-immune, so bulk traffic
        cannot starve behind a steady latency stream)."""
        cap = self.max_preemptions
        out = []
        for s in c.slots:
            if s in target or self.table.slot_empty(s):
                continue
            if (self.min_residency and
                    self.t - int(self.slot_since[s]) < self.min_residency):
                continue
            reqs = [self.requests[int(r)] for r in self.table.grid[s]
                    if r >= 0]
            if cap and any(r.preempted >= cap for r in reqs):
                continue
            out.append((s, reqs))
        return out

    def _preempt_one(self, target: dict, fresh: set,
                     to_reset: np.ndarray, wload=None) -> bool:
        """Park one victim slot for the head request, if the eviction
        policy names one and the freed slot verifiably fits the request —
        the subsequent fill round then admits it there.  Victims are
        sought class by class in the width policy's order, so a latency
        request preempts on the narrow slots it would ride.  Returns
        whether a preemption happened."""
        req = self._peek()
        if req is None:
            return False
        for ci in self._class_order(req, wload):
            c = self.classes[ci]
            end = c.prefix_len + len(req.prompt) + req.max_new_tokens
            if end > c.max_len:
                continue
            victim = self.eviction.select_victim(
                req, self._park_candidates(target, c))
            if victim is None:
                continue
            group_reserve = 0
            if self.paged:
                alloc = c.allocator
                # The park itself reprovisions fresh prefix pages for the
                # freed slot; pages freed by this round's recycles return
                # to the free list only at the batched reset, so check the
                # list directly.
                if alloc.table.free_pages < alloc.n_prefix_pages:
                    continue
                group_reserve = pages_for(int(self.lane_end[victim].max()),
                                          alloc.page_size)
                if not self._fits_pages(c, fresh | {victim}, {victim: end},
                                        extra_reserved=group_reserve):
                    continue
            self._park(victim, group_reserve, target, fresh, to_reset)
            return True
        return False

    def _park(self, victim: int, group_reserve: int, target: dict,
              fresh: set, to_reset: np.ndarray) -> None:
        """Move the victim slot's live lanes into the swap ledger and hand
        the slot, rewound to the primed prefix, to the next admission."""
        c = self._cls(victim)
        lanes: dict[int, Request] = {}
        for l in range(self.n_lanes):
            rid = int(self.table.grid[victim, l])
            if rid < 0:
                continue
            req = self.requests[rid]
            req.preempted += 1
            self.table.release(victim, l)
            lanes[l] = req
            if self.tracer.enabled:
                self.tracer.event("preempt", rid=req.rid, slot=victim,
                                  lane=l, pos=int(self.pos[victim]))
        self.ledger.append(ParkedGroup(
            lanes=lanes, pos=int(self.pos[victim]),
            horizon=int(self.lane_end[victim].max()), parked_step=self.t,
            payload=c.allocator.park_slot(c.local(victim)),
            reserved_pages=group_reserve, wclass=c.index))
        self.lane_end[victim] = -1
        target[victim] = int(self.prefix_by_slot[victim])
        fresh.add(victim)
        to_reset[victim] = True
        self.stats.preemptions += 1

    def _fits_fresh(self, req: Request, slot: int) -> bool:
        """Would ``req`` be admitted into ``slot`` rewound to the primed
        prefix — the same horizon/pool arithmetic the fill loop applies to
        a fresh slot."""
        c = self._cls(slot)
        end = c.prefix_len + len(req.prompt) + req.max_new_tokens
        if end > c.max_len:
            return False
        return not self.paged or self._fits_pages(c, {slot}, {slot: end})

    def _resume_parked(self, target: dict) -> None:
        """Restore parked groups (oldest first) into empty slots.  At most
        one empty slot is left to the fill loop, and only when the queue's
        head request outranks the oldest group *and* verifiably fits a
        fresh slot — resuming there would just re-park the group.  A head
        that cannot fit never blocks resumption: otherwise a parked
        group's page reservation could livelock the pool (head
        unadmittable, group never resumed, nothing ever progresses).  Pool
        fit of the group itself needs no re-check — parked groups keep
        their worst-case footprint reserved in ``_fits_pages``."""
        reserved_for_head = False
        for slot in range(self.n_slots):
            if not len(self.ledger):
                break
            if slot in target or not self.table.slot_empty(slot):
                continue
            c = self._cls(slot)
            # Oldest parked group of this slot's width class — the cache
            # payload's shape is class-specific, so a group can only ever
            # resume where it parked.  Single class: the ledger head.
            group = next((g for g in self.ledger if g.wclass == c.index),
                         None)
            if group is None:
                continue
            head = self._peek()
            if (not reserved_for_head and head is not None
                    and self.eviction.outranks(head,
                                               list(group.lanes.values()))
                    and self._fits_fresh(head, slot)):
                reserved_for_head = True
                continue
            self.ledger.take(group)
            c.allocator.resume_slot(c.local(slot), group.payload)
            self.pos[slot] = group.pos
            for l, req in group.lanes.items():
                self.table.occupy(slot, l, req.rid)
                if self.tracer.enabled:
                    self.tracer.event("resume", rid=req.rid, slot=slot,
                                      lane=l, pos=group.pos,
                                      parked_steps=self.t - group.parked_step)
            idx, ends, _ = self._slot_horizons(slot, group.pos)
            for l, e in zip(idx, ends):
                self.lane_end[slot, l] = e
            target[slot] = group.pos
            self.slot_since[slot] = self.t
            self.stats.resumes += 1

    # -- one decode step --------------------------------------------------------

    def step(self) -> None:
        """Admit, run one decode step for all B slots, then ramp /
        sample / retire per lane."""
        self.tracer.now = self.t
        self._admit()
        if self.chunk > 1:
            mask, released, advance = self._run_chunked_step()
        else:
            mask, released, advance = self._run_single_step()
        self._finish_step(mask, released, advance)

    def _run_single_step(self):
        """Legacy one-token step: every live lane feeds exactly one token
        (prompt ramp or last output) and every slot advances one position —
        the ``prefill_chunk == 1`` path, bit-for-bit the original engine."""
        mask = self.table.lane_mask()                    # (B, N_max)
        tokens = np.zeros((self.n_slots, self.n_lanes), np.int32)
        for s in range(self.n_slots):
            for l in range(self.n_lanes):
                rid = int(self.table.grid[s, l])
                if rid < 0:
                    continue
                req = self.requests[rid]
                tokens[s, l] = req.prompt[req.fed] if req.ramping \
                    else req.output[-1]

        # One variant launch per width class over its slot block.  An idle
        # class skips its launch entirely (multi-class only: the
        # single-class scheduler steps unconditionally, like it always
        # has), and a skipped class's positions do not advance.
        logits_by_class: list = [None] * len(self.classes)
        released = set()
        for c in self.classes:
            sl = slice(c.start, c.start + c.n_slots)
            cmask = mask[sl, :c.width]
            if self.multiclass and not cmask.any():
                continue
            block_table = None
            if self.paged:
                # Map every live slot's write position to a page; empty
                # slots write to the allocator's trash page.
                c.allocator.ensure(self.pos[sl], cmask.sum(axis=1) > 0)
                block_table = c.allocator.block_table
            state = ServeState(cache=c.allocator.cache,
                               pos=self.pos[sl].copy(),
                               index_embeds=c.index_embeds)
            toks = tokens[sl, :c.width] if c.mux_active \
                else tokens[sl, 0]
            logits, state = c.engine.step(state, toks, lane_mask=cmask,
                                          block_table=block_table)
            c.allocator.adopt(state.cache)
            self.pos[sl] += 1
            logits = _host_logits(logits)                # (b, w, V)
            if not c.mux_active:
                logits = logits[:, None, :]              # (b, 1, V)
            logits_by_class[c.index] = logits

        for c in self.classes:
            logits = logits_by_class[c.index]
            if logits is None:
                continue
            for s in c.slots:
                for l in range(c.width):
                    rid = int(self.table.grid[s, l])
                    if rid < 0:
                        continue
                    req = self.requests[rid]
                    if req.ramping:
                        req.fed += 1
                        if req.ramping:  # prompt not fully consumed yet
                            continue
                    self._emit(req, logits[c.local(s), l], s, l, released)
        return mask, released, None

    def _run_chunked_step(self):
        """Chunked-prefill step (``prefill_chunk`` C > 1): each ramping lane
        feeds up to C prompt tokens, its slot advances by the largest ramp
        take (min 1), and the slot's non-ramping lanes decode exactly one
        token — their extra chunk rows masked out of the mixed stream and
        the logits (``lane_mask`` is (B, N, C) here)."""
        C = self.chunk
        mask = self.table.lane_mask()                    # (B, N_max) occup.
        tokens = np.zeros((self.n_slots, self.n_lanes, C), np.int32)
        contrib = np.zeros((self.n_slots, self.n_lanes, C), np.float32)
        valid = np.ones(self.n_slots, np.int32)          # rows per slot
        takes = np.zeros((self.n_slots, self.n_lanes), np.int32)
        for s in range(self.n_slots):
            for l in range(self.n_lanes):
                rid = int(self.table.grid[s, l])
                if rid < 0:
                    continue
                req = self.requests[rid]
                if req.ramping:
                    take = min(C, len(req.prompt) - req.fed)
                    tokens[s, l, :take] = req.prompt[req.fed:req.fed + take]
                    contrib[s, l, :take] = 1.0
                    takes[s, l] = take
                    valid[s] = max(valid[s], take)
                else:
                    tokens[s, l, 0] = req.output[-1]
                    contrib[s, l, 0] = 1.0

        logits_by_class: list = [None] * len(self.classes)
        released = set()
        for c in self.classes:
            sl = slice(c.start, c.start + c.n_slots)
            cmask = mask[sl, :c.width]
            if self.multiclass and not cmask.any():
                valid[sl] = 0            # skipped class: no position take
                continue
            block_table = None
            if self.paged:
                # Map every live slot's write range [pos, pos+valid) to
                # pages.
                c.allocator.ensure(self.pos[sl], cmask.sum(axis=1) > 0,
                                   lens=valid[sl])
                block_table = c.allocator.block_table
            state = ServeState(cache=c.allocator.cache,
                               pos=self.pos[sl].copy(),
                               index_embeds=c.index_embeds)
            ctoks = tokens[sl, :c.width, :] if c.mux_active \
                else tokens[sl, 0, :]
            logits, state = c.engine.step(state, ctoks,
                                          lane_mask=contrib[sl, :c.width],
                                          block_table=block_table,
                                          chunk_lens=valid[sl])
            c.allocator.adopt(state.cache)
            self.pos[sl] += valid[sl]
            logits = _host_logits(logits)                # (b, w, C, V)
            if not c.mux_active:
                logits = logits[:, None, :, :]           # (b, 1, C, V)
            logits_by_class[c.index] = logits

        for c in self.classes:
            logits = logits_by_class[c.index]
            if logits is None:
                continue
            for s in c.slots:
                for l in range(c.width):
                    rid = int(self.table.grid[s, l])
                    if rid < 0:
                        continue
                    req = self.requests[rid]
                    if req.ramping:
                        take = int(takes[s, l])
                        req.fed += take
                        if req.ramping:  # prompt not fully consumed yet
                            continue
                        row = take - 1   # first token: last prompt row
                    else:
                        row = 0
                    self._emit(req, logits[c.local(s), l, row], s, l,
                               released)
        return mask, released, valid

    def _emit(self, req: Request, lane_logits, s: int, l: int,
              released: set) -> None:
        """Sample one token for a lane; retire it on EOS / length budget."""
        tok = self.sampling.select(req, lane_logits)
        if not req.output:
            req.ttft = self.t - req.arrival
            if self.multiclass and req.width:
                acc = self._width_ttft.setdefault(req.width, [0, 0])
                acc[0] += req.ttft
                acc[1] += 1
            if self.tracer.enabled:
                self.tracer.event("first_token", rid=req.rid, slot=s, lane=l,
                                  ttft=req.ttft)
        req.output.append(tok)
        self.stats.generated_tokens += 1
        if (len(req.output) >= req.max_new_tokens or
                (req.eos_id is not None and tok == req.eos_id)):
            self.table.release(s, l)
            self.lane_end[s, l] = -1
            released.add(s)
            req.finished_step = self.t
            self.finished.append(req)
            self.stats.finished += 1
            if self.tracer.enabled:
                self.tracer.event("retire", rid=req.rid, slot=s, lane=l,
                                  tokens=len(req.output),
                                  preempted=req.preempted)

    def _finish_step(self, mask, released, advance=None) -> None:
        if self.paged:
            # Free-on-retire: recycle drained slots eagerly so their pages
            # return to the pool now, not at the next admission into them.
            drained = np.array([s in released and self.table.slot_empty(s)
                                for s in range(self.n_slots)])
            if drained.any():
                for c in self.classes:
                    sel = drained[c.start:c.start + c.n_slots]
                    if sel.any():
                        c.allocator.reset_slots(sel)
                self.pos[drained] = self.prefix_by_slot[drained]
                self.stats.slot_resets += int(drained.sum())
            self.stats.peak_pages = max(
                self.stats.peak_pages,
                sum(c.allocator.table.peak_in_use for c in self.classes))

        self.stats.decode_steps += 1
        self.stats.occupancy_sum += float(mask.mean())
        self.stats.slot_active_steps += (mask.sum(axis=1) > 0)
        tr = self.tracer
        if tr.enabled:
            # Per-slot timeline: one duration event per live slot per step
            # (``advance`` is the chunked per-slot position take, None for
            # the one-token step), then the per-step metric snapshot.
            live = mask.sum(axis=1) > 0
            for s in range(self.n_slots):
                if not live[s]:
                    continue
                adv = 1 if advance is None else int(advance[s])
                tr.event("slot_step", slot=s, lanes=int(mask[s].sum()),
                         advance=adv, ramping=adv > 1)
            m = tr.metrics
            m.gauge("queue_depth", self._waiting())
            m.gauge("live_lanes", int(mask.sum()))
            m.gauge("parked_groups", len(self.ledger))
            m.gauge("generated_tokens", self.stats.generated_tokens)
            m.gauge("decode_steps", self.stats.decode_steps)
            m.gauge("preemptions", self.stats.preemptions)
            if self.multiclass:
                # Width-class gauges (multi-class only, so the fixed-N
                # metric rows stay byte-identical): live lanes per class,
                # variant count, per-class mean TTFT so far.
                m.gauge("width_variants", self.engine.variant_compiles)
                for c in self.classes:
                    lanes = int(mask[c.start:c.start + c.n_slots,
                                     :c.width].sum())
                    m.gauge(f"width{c.width}_lanes", lanes)
                    acc = self._width_ttft.get(c.width)
                    if acc:
                        m.gauge(f"width{c.width}_ttft_mean",
                                acc[0] / acc[1])
            if self.paged:
                m.gauge("pages_in_use",
                        sum(c.allocator.table.pages_in_use
                            for c in self.classes))
                m.gauge("free_pages",
                        sum(c.allocator.table.free_pages
                            for c in self.classes))
                m.gauge("peak_pages",
                        sum(c.allocator.table.peak_in_use
                            for c in self.classes))
                if self.engine.cfg.serving.use_kernel:
                    # K-blocks walked and all-unmapped K-blocks skipped by
                    # this step's kernel launch (per layer — every layer
                    # walks the same block table; width classes launch once
                    # per class, summed here).
                    grid = skipped = 0
                    for c in self.classes:
                        g, sk, _ = kblock_stats(
                            np.asarray(c.allocator.table.rows),
                            c.engine.cfg.serving.kblock_pages,
                            c.engine.cfg.n_kv_heads)
                        grid += g
                        skipped += sk
                    m.count("kernel_grid_steps", grid)
                    m.count("kernel_skipped_blocks", skipped)
            tr.snap(self.t)
        self.t += 1

    # -- drive a whole trace ------------------------------------------------------

    def run(self, requests: Optional[list[Request]] = None, *,
            max_steps: int = 100_000) -> SchedulerStats:
        """Replay a trace to completion.  The clock jumps over fully idle
        gaps (no live or parked lanes, next arrival in the future) without
        burning decode steps."""
        for r in (requests or []):
            self.submit(r)
        while (self._waiting() or self.table.live_requests()
               or len(self.ledger)) and \
                self.stats.decode_steps < max_steps:
            nxt = self._next_arrival()
            if not self.table.live_requests() and not len(self.ledger) and \
                    nxt is not None and nxt > self.t:
                if self.tracer.enabled:
                    self.tracer.event("idle", ts=self.t, gap=nxt - self.t)
                self.stats.idle_steps += nxt - self.t
                self.t = nxt
            self.step()
        self.stats.finalize(self.finished, self.slo)
        self.stats.final_load = self.load()
        return self.stats

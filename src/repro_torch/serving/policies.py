"""Serving policies: pluggable admission / eviction / sampling — the
port's own copy of ``repro.serving.policies`` (numpy only).

This module factors the scheduler's decision surfaces into protocols
resolved by name from a registry (mirroring ``repro_torch.core.strategies``), so the scheduler only
orchestrates step execution:

  * ``AdmissionPolicy`` — which queued request is offered the next free
    lane.  ``fifo`` preserves strict head-of-line order; ``priority`` serves
    the highest ``Request.priority`` among arrived requests; ``slo`` is
    earliest-deadline-first over SLO classes (``ServingConfig.slo_classes``
    maps class name -> TTFT deadline in decode steps; class order is rank —
    earlier entries outrank later ones, unclassed requests take the last).
  * ``EvictionPolicy`` — which live slot yields when an admissible request
    outranks it and ``preempt`` is on (the victim's lanes park in the swap
    ledger and resume later, see ``serving/slots.py``).  ``none`` never
    preempts; ``priority`` ranks by ``Request.priority``; ``slo`` ranks by
    SLO class.  Both pick the most-preemptible slot (worst best-lane rank),
    then the youngest (least progress lost), and never evict a slot holding
    a peer- or higher-ranked lane.
  * ``SamplingPolicy`` — per-lane next-token selection.  ``lane`` is
    exact argmax at temperature 0 (the bit-for-bit default
    path), seeded per-request Gumbel-max otherwise.
  * ``WidthPolicy`` — which mux-width class an admitted request rides when
    ``ServingConfig.width_set`` partitions the slots into compiled
    N-variants (adaptive multiplexing width).  ``static`` sends everything
    widest-first (raw tok/step); ``slo_tiered`` maps SLO rank onto the
    width ladder (rank 0 narrowest-first for per-stream fidelity and short
    mixed streams, lowest rank widest-first); ``load_adaptive`` starts from
    the tiered order and re-weights it from the live ``SchedulerLoad``
    probe (classes with open lanes and free pages first).

Authoring a policy is the same three steps as a mux strategy: subclass,
``@register_*("name")``, pass the name (``ServingConfig.policy``) or an
instance to ``ContinuousScheduler``.  Admission policies are stateful (they
own the queue) and are instantiated per scheduler; eviction/sampling
implementations must be stateless.
"""
from __future__ import annotations

import collections
import heapq
from typing import Callable, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T", bound=type)

_ADMISSION: dict[str, type] = {}
_EVICTION: dict[str, type] = {}
_SAMPLING: dict[str, type] = {}
_WIDTH: dict[str, type] = {}


def _register(table: dict[str, type], kind: str, name: str):
    def deco(cls: T) -> T:
        if name in table:
            raise ValueError(
                f"{kind} policy {name!r} already registered "
                f"({table[name].__name__}); unregister first to replace it")
        cls.name = name
        table[name] = cls
        return cls
    return deco


def register_admission(name: str) -> Callable[[T], T]:
    """Class decorator: register an AdmissionPolicy under ``name``."""
    return _register(_ADMISSION, "admission", name)


def register_eviction(name: str) -> Callable[[T], T]:
    """Class decorator: register an EvictionPolicy under ``name``."""
    return _register(_EVICTION, "eviction", name)


def register_sampling(name: str) -> Callable[[T], T]:
    """Class decorator: register a SamplingPolicy under ``name``."""
    return _register(_SAMPLING, "sampling", name)


def register_width(name: str) -> Callable[[T], T]:
    """Class decorator: register a WidthPolicy under ``name``."""
    return _register(_WIDTH, "width", name)


def _get(table: dict[str, type], kind: str, name: str) -> type:
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} policy {name!r}; registered: "
            f"{sorted(table)}") from None


def get_admission(name: str) -> type:
    return _get(_ADMISSION, "admission", name)


def get_eviction(name: str) -> type:
    return _get(_EVICTION, "eviction", name)


def get_sampling(name: str) -> type:
    return _get(_SAMPLING, "sampling", name)


def get_width(name: str) -> type:
    return _get(_WIDTH, "width", name)


def list_admission() -> list[str]:
    return sorted(_ADMISSION)


def list_eviction() -> list[str]:
    return sorted(_EVICTION)


def list_sampling() -> list[str]:
    return sorted(_SAMPLING)


def list_width() -> list[str]:
    return sorted(_WIDTH)


def unregister_admission(name: str) -> None:
    _ADMISSION.pop(name, None)


def unregister_eviction(name: str) -> None:
    _EVICTION.pop(name, None)


def unregister_sampling(name: str) -> None:
    _SAMPLING.pop(name, None)


def unregister_width(name: str) -> None:
    _WIDTH.pop(name, None)


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------

class SloClasses:
    """Ordered SLO classes from ``ServingConfig.slo_classes``:
    ``((name, ttft_deadline_steps), ...)``.  Position is rank — index 0
    outranks everything after it.  Unknown / empty class names resolve to
    the last (lowest) class, so unclassed requests are best-effort batch."""

    def __init__(self, classes: Sequence[tuple]):
        self.names = tuple(name for name, _ in classes)
        self.deadlines = {name: int(d) for name, d in classes}
        self._rank = {name: i for i, name in enumerate(self.names)}

    def resolve(self, slo: str) -> str:
        if slo in self._rank:
            return slo
        # No classes configured at all (possible for hand-built instances —
        # ServingConfig itself requires at least one): every name resolves
        # to itself with rank 0 / deadline 0, so stats code that iterates
        # ``names`` simply reports nothing instead of crashing.
        return self.names[-1] if self.names else slo

    def rank(self, slo: str) -> int:
        """0 = highest class; unknown names take the lowest rank."""
        return self._rank.get(self.resolve(slo), 0)

    def deadline(self, slo: str) -> int:
        """TTFT deadline (scheduler steps from arrival) for the class."""
        return self.deadlines.get(self.resolve(slo), 0)


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------

class AdmissionPolicy:
    """Queue ordering: which arrived request is offered the next free lane.

    Stateful — owns the waiting requests.  ``peek``/``pop`` must agree (pop
    returns exactly the request peek last showed for the same ``now``), and
    only *arrived* requests (``req.arrival <= now``) may surface.
    ``default_eviction`` names the EvictionPolicy paired with this ordering
    when ``preempt=True`` and no explicit eviction policy is given.
    """

    name = "?"
    default_eviction = "none"

    def __init__(self, slo: SloClasses):
        self.slo = slo

    def push(self, req) -> None:
        raise NotImplementedError

    def peek(self, now: int):
        raise NotImplementedError

    def pop(self, now: int):
        raise NotImplementedError

    def waiting(self) -> int:
        raise NotImplementedError

    def next_arrival(self, now: int) -> Optional[int]:
        """Earliest step at which ``peek`` could return a request, or None
        when the queue is empty (lets the scheduler skip idle gaps)."""
        raise NotImplementedError


@register_admission("fifo")
class FifoAdmission(AdmissionPolicy):
    """Strict head-of-line order: the oldest submitted request blocks every
    later one, even when a later one would fit — the default."""

    def __init__(self, slo: SloClasses):
        super().__init__(slo)
        self.queue: collections.deque = collections.deque()

    def push(self, req) -> None:
        self.queue.append(req)

    def peek(self, now: int):
        if self.queue and self.queue[0].arrival <= now:
            return self.queue[0]
        return None

    def pop(self, now: int):
        return self.queue.popleft()

    def waiting(self) -> int:
        return len(self.queue)

    def next_arrival(self, now: int) -> Optional[int]:
        return self.queue[0].arrival if self.queue else None


class _HeapAdmission(AdmissionPolicy):
    """Arrival-ordered queue + ready heap: arrived requests are pulled into
    the heap and served best-key first.  Subclasses define the key."""

    def __init__(self, slo: SloClasses):
        super().__init__(slo)
        self.queue: collections.deque = collections.deque()
        self._ready: list[tuple] = []

    def _key(self, req) -> tuple:
        raise NotImplementedError

    def push(self, req) -> None:
        self.queue.append(req)

    def _pull_arrived(self, now: int) -> None:
        while self.queue and self.queue[0].arrival <= now:
            req = self.queue.popleft()
            heapq.heappush(self._ready, self._key(req) + (req.rid, req))

    def peek(self, now: int):
        self._pull_arrived(now)
        return self._ready[0][-1] if self._ready else None

    def pop(self, now: int):
        self._pull_arrived(now)
        return heapq.heappop(self._ready)[-1]

    def waiting(self) -> int:
        return len(self.queue) + len(self._ready)

    def next_arrival(self, now: int) -> Optional[int]:
        if self._ready:
            return now
        return self.queue[0].arrival if self.queue else None


@register_admission("priority")
class PriorityAdmission(_HeapAdmission):
    """Highest ``Request.priority`` first among arrived requests, FIFO
    within a priority level."""

    default_eviction = "priority"

    def _key(self, req) -> tuple:
        return (-req.priority, req.arrival)


@register_admission("slo")
class SloAdmission(_HeapAdmission):
    """Earliest-deadline-first over SLO classes: key is the absolute TTFT
    deadline (``arrival + class deadline``), class rank breaking ties — a
    latency-class request with a tight deadline overtakes batch work that
    arrived first, without starving batch forever (its deadline ages)."""

    default_eviction = "slo"

    def _key(self, req) -> tuple:
        return (req.arrival + self.slo.deadline(req.slo),
                self.slo.rank(req.slo), req.arrival)


# ---------------------------------------------------------------------------
# Eviction
# ---------------------------------------------------------------------------

class EvictionPolicy:
    """Victim selection for preempt-and-swap.

    ``_rank(req)`` orders requests (smaller = more important).  A slot is
    evictable for an incoming request only if the request strictly outranks
    *every* live lane in it — peers never evict peers, so admission cannot
    thrash two equal-class requests through the same slot.  Among evictable
    slots the policy parks the one whose best lane matters least, breaking
    ties toward the youngest group (least progress lost on the swap).
    Stateless — one instance may serve many schedulers.
    """

    name = "?"

    def __init__(self, slo: SloClasses):
        self.slo = slo

    def _rank(self, req) -> float:
        raise NotImplementedError

    def outranks(self, req, others: Sequence) -> bool:
        """True iff ``req`` is strictly more important than all ``others``."""
        return bool(others) and all(
            self._rank(req) < self._rank(o) for o in others)

    def select_victim(self, req, candidates) -> Optional[int]:
        """``candidates``: (slot, live requests) pairs eligible for parking.
        Returns the victim slot, or None to leave the queue waiting."""
        best = None
        for slot, reqs in candidates:
            if not self.outranks(req, reqs):
                continue
            key = (min(self._rank(r) for r in reqs),
                   max(r.admitted_step for r in reqs), -slot)
            if best is None or key > best[0]:
                best = (key, slot)
        return best[1] if best else None


@register_eviction("none")
class NoEviction(EvictionPolicy):
    """Never preempt (the fifo pairing): outranks nothing."""

    def outranks(self, req, others) -> bool:
        return False

    def select_victim(self, req, candidates) -> Optional[int]:
        return None


@register_eviction("priority")
class PriorityEviction(EvictionPolicy):
    """Rank by ``Request.priority`` (higher priority = more important)."""

    def _rank(self, req) -> float:
        return -req.priority


@register_eviction("slo")
class SloEviction(EvictionPolicy):
    """Rank by SLO class: latency-class requests may park batch-class
    slots; batch never parks anyone."""

    def _rank(self, req) -> float:
        return self.slo.rank(req.slo)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

class SamplingPolicy:
    """Per-lane next-token selection from that lane's demuxed logits."""

    name = "?"

    def __init__(self, slo: SloClasses):
        self.slo = slo

    def select(self, req, logits: np.ndarray) -> int:
        raise NotImplementedError


@register_sampling("lane")
class LaneSampling(SamplingPolicy):
    """Lane-aware sampling: zero temperature is the exact argmax of the
    greedy path; otherwise Gumbel-max from the
    request's own seeded generator, so each lane of the mixed stream
    samples independently."""

    def select(self, req, logits: np.ndarray) -> int:
        if req.temperature > 0.0:
            if req.rng is None:
                seed = req.seed if req.seed is not None else req.rid
                req.rng = np.random.default_rng(seed)
            z = np.asarray(logits, np.float64) / req.temperature
            return int(np.argmax(z + req.rng.gumbel(size=z.shape)))
        return int(np.argmax(logits))


# ---------------------------------------------------------------------------
# Width classes (adaptive multiplexing width)
# ---------------------------------------------------------------------------

class WidthPolicy:
    """Width-class preference at admission, for schedulers whose slots are
    partitioned into mux-width classes (``ServingConfig.width_set``).

    ``order`` returns class *indices* (into the ascending width tuple) in
    preference order; the scheduler offers the request to each class in
    turn and admits into the first one with a lane that fits.  ``load`` is
    the scheduler's ``SchedulerLoad`` probe (``width_loads`` carries the
    per-class occupancy) — None when the probe is unavailable, and policies
    must stay deterministic given (request, widths, load).
    Stateless — one instance may serve many schedulers.
    """

    name = "?"

    def __init__(self, slo: SloClasses):
        self.slo = slo

    def order(self, req, widths: Sequence[int], load=None) -> list[int]:
        raise NotImplementedError


@register_width("static")
class StaticWidth(WidthPolicy):
    """Widest-first for every request regardless of SLO or load: maximum
    superposition (raw tok/step), narrow classes only as overflow."""

    def order(self, req, widths, load=None) -> list[int]:
        return list(range(len(widths) - 1, -1, -1))


@register_width("slo_tiered")
class SloTieredWidth(WidthPolicy):
    """Map SLO rank onto the width ladder: rank 0 (highest class) targets
    the narrowest width — shorter mixed stream, higher per-stream fidelity,
    fastest TTFT — the lowest rank targets the widest, and middle ranks
    interpolate.  From the target the preference walks outward, wider side
    first (spare capacity should cost throughput before it costs the
    latency tier its narrow lanes)."""

    def order(self, req, widths, load=None) -> list[int]:
        k = len(widths)
        if k <= 1:
            return list(range(k))
        top = max(1, len(self.slo.names) - 1)
        target = round(self.slo.rank(req.slo) / top * (k - 1))
        rest = sorted((i for i in range(k) if i != target),
                      key=lambda i: (abs(i - target), -i))
        return [target] + rest


@register_width("load_adaptive")
class LoadAdaptiveWidth(SloTieredWidth):
    """``slo_tiered`` re-weighted by the live load probe: classes that can
    take the request *now* (an open lane, and under paging at least one
    free page) move ahead of saturated ones, preserving the tiered order
    within each group.  Queue pressure keeps the tiered target honest —
    with no probe (or a probe without width data) this is exactly
    ``slo_tiered``."""

    def order(self, req, widths, load=None) -> list[int]:
        base = super().order(req, widths, load)
        wl = getattr(load, "width_loads", ()) if load is not None else ()
        if not wl or len(wl) != len(widths):
            return base
        def saturated(i):
            cls = wl[i]
            if cls.get("free_lanes", 0) <= 0:
                return True
            pages = cls.get("free_pages")
            return pages is not None and pages <= 0
        return sorted(base, key=saturated)


def resolve(kind: str, spec, slo: SloClasses):
    """Resolve a policy ``spec`` (registered name or instance) for ``kind``
    in {"admission", "eviction", "sampling", "width"}."""
    table = {"admission": _ADMISSION, "eviction": _EVICTION,
             "sampling": _SAMPLING, "width": _WIDTH}[kind]
    base = {"admission": AdmissionPolicy, "eviction": EvictionPolicy,
            "sampling": SamplingPolicy, "width": WidthPolicy}[kind]
    if isinstance(spec, base):
        return spec
    if isinstance(spec, str):
        return _get(table, kind, spec)(slo)
    raise TypeError(f"{kind} policy must be a registered name or a "
                    f"{base.__name__} instance, got {type(spec).__name__}")

"""Slot table: B backbone slots × N mux lanes → live request ids.

The serving unit of DataMUX is a *lane*: one of the N multiplexed streams
sharing a backbone slot's KV cache.  Continuous batching needs lane-level
granularity — a slot whose lane 2 finished must admit a new request into
lane 2 while lanes 0/1/3 keep decoding — so the table tracks occupancy per
(slot, lane) cell, not per slot.

Pure-Python bookkeeping (no tensors): the scheduler turns ``lane_mask()`` into
the device-side mask each step.  Positions live in the scheduler; cache
contents live in the ``KVSlotAllocator``.

Preempt-and-swap (``SwapLedger``): a slot's N lanes share one mixed-stream
cache, so the *swap unit is the whole slot* — parking a victim parks every
live lane of it together (a ``ParkedGroup``), and the group later resumes
together into any empty slot, cache state and positions restored exactly.
The ledger is FIFO over groups; the cache payload (a detached block-table
row under paging, a full slot snapshot contiguous) is opaque to it and
owned by the allocator that produced it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.serving.telemetry import NULL_TRACER

FREE = -1
# Width-class serving (ServingConfig.width_set): a slot narrower than the
# table's widest class marks its lanes >= its own width DISABLED — never
# free, never occupiable, masked out of every mask/occupancy query.
DISABLED = -2


@dataclasses.dataclass(eq=False)  # identity equality: the payload holds
                                  # arrays, and ``SwapLedger.take`` removes
                                  # by the exact group object
class ParkedGroup:
    """One preempted slot's lanes, frozen mid-decode.

    ``lanes`` maps lane index -> the live ``Request`` (its runtime state —
    ramp cursor, outputs, sampler rng — rides along, so resumption feeds
    ``output[-1]`` and continues bitwise).  ``payload`` is the allocator's
    parked cache state; ``reserved_pages`` keeps the group's worst-case
    footprint counted in paged admission while it is off the table, which
    guarantees a parked group can always resume without re-checking the
    pool (an empty slot is the only thing it waits for)."""
    lanes: dict[int, Any]          # lane -> Request
    pos: int                       # slot position at park time
    horizon: int                   # exclusive worst-case end position
    parked_step: int               # scheduler clock at park time
    payload: Any                   # allocator park state (opaque)
    reserved_pages: int = 0        # paged: pages_for(horizon), else 0
    wclass: int = 0                # width-class index the slot belonged to
                                   # (resume must land in the same class —
                                   # the cache shape is class-specific)


class SwapLedger:
    """FIFO of parked groups awaiting resumption."""

    def __init__(self):
        self._groups: collections.deque[ParkedGroup] = collections.deque()
        # Telemetry recorder; rebound by ``ContinuousScheduler.set_tracer``.
        self.tracer = NULL_TRACER

    def append(self, group: ParkedGroup) -> None:
        if self.tracer.enabled:
            self.tracer.event("swap_out",
                              rids=[r.rid for r in group.lanes.values()],
                              pos=group.pos,
                              reserved_pages=group.reserved_pages)
        self._groups.append(group)

    def head(self) -> ParkedGroup:
        return self._groups[0]

    def popleft(self) -> ParkedGroup:
        return self.take(self._groups[0])

    def take(self, group: ParkedGroup) -> ParkedGroup:
        """Remove a specific group (width-class resume takes the oldest
        group *of the slot's class*, which need not be the FIFO head)."""
        self._groups.remove(group)
        if self.tracer.enabled:
            self.tracer.event("swap_in",
                              rids=[r.rid for r in group.lanes.values()],
                              pos=group.pos,
                              parked_steps=self.tracer.now
                              - group.parked_step)
        return group

    def __len__(self) -> int:
        return len(self._groups)

    def __iter__(self) -> Iterator[ParkedGroup]:
        return iter(self._groups)

    def reserved_pages(self, wclass: Optional[int] = None) -> int:
        """Pages held out of admission's budget by parked groups (of one
        width class when ``wclass`` is given — page pools are per-class)."""
        return sum(g.reserved_pages for g in self._groups
                   if wclass is None or g.wclass == wclass)

    def live_requests(self) -> list[int]:
        """Request ids parked in the ledger (still in flight, not lost)."""
        return [r.rid for g in self._groups for r in g.lanes.values()]


@dataclasses.dataclass
class SlotTable:
    n_slots: int
    n_lanes: int
    lane_counts: Optional[Any] = None  # per-slot lane count (width classes);
                                       # None -> homogeneous n_lanes

    def __post_init__(self):
        # grid[s][l] = request id, FREE, or DISABLED (lanes beyond the
        # slot's own width-class lane count)
        self.grid = np.full((self.n_slots, self.n_lanes), FREE, np.int64)
        if self.lane_counts is None:
            self.lane_counts = np.full(self.n_slots, self.n_lanes, np.int64)
        else:
            self.lane_counts = np.asarray(self.lane_counts, np.int64)
            if self.lane_counts.shape != (self.n_slots,):
                raise ValueError(
                    f"lane_counts must be one count per slot, got shape "
                    f"{self.lane_counts.shape} for {self.n_slots} slots")
            if (self.lane_counts < 1).any() or \
                    (self.lane_counts > self.n_lanes).any():
                raise ValueError(
                    f"lane counts must be in [1, {self.n_lanes}], got "
                    f"{self.lane_counts.tolist()}")
            for s in range(self.n_slots):
                self.grid[s, self.lane_counts[s]:] = DISABLED

    # -- queries --------------------------------------------------------------

    def lane_mask(self) -> np.ndarray:
        """(B, N) float mask: 1 for occupied lanes (disabled lanes are 0)."""
        return (self.grid >= 0).astype(np.float32)

    def free_lanes(self) -> Iterator[tuple[int, int]]:
        """(slot, lane) pairs currently free, slot-major order."""
        for s in range(self.n_slots):
            for l in range(int(self.lane_counts[s])):
                if self.grid[s, l] == FREE:
                    yield (s, l)

    def slot_empty(self, slot: int) -> bool:
        return bool((self.grid[slot] < 0).all())

    def lane_of(self, rid: int) -> Optional[tuple[int, int]]:
        hits = np.argwhere(self.grid == rid)
        return tuple(int(v) for v in hits[0]) if len(hits) else None

    def live_requests(self) -> list[int]:
        return [int(r) for r in self.grid.ravel() if r >= 0]

    def occupancy(self) -> float:
        """Fraction of *enabled* lanes occupied — the mux utilisation the
        paper's throughput win depends on."""
        return float((self.grid >= 0).sum() / max(1, (self.grid != DISABLED).sum()))

    # -- transitions ----------------------------------------------------------

    def occupy(self, slot: int, lane: int, rid: int) -> None:
        if self.grid[slot, lane] == DISABLED:
            raise ValueError(
                f"lane ({slot}, {lane}) is disabled: slot {slot} serves "
                f"{int(self.lane_counts[slot])} lane(s)")
        if self.grid[slot, lane] != FREE:
            raise ValueError(
                f"lane ({slot}, {lane}) already holds request "
                f"{int(self.grid[slot, lane])}")
        self.grid[slot, lane] = rid

    def release(self, slot: int, lane: int) -> int:
        rid = int(self.grid[slot, lane])
        if rid < 0:
            raise ValueError(f"lane ({slot}, {lane}) is already free")
        self.grid[slot, lane] = FREE
        return rid

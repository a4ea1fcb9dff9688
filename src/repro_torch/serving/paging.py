"""Paged KV cache: block-table allocator over a shared page pool — the port
of ``repro.serving.paging``.

The contiguous ``KVSlotAllocator`` gives every backbone slot a private
``max_len`` region, so admission must refuse a request that would overflow
a slot, and one long generation pins a whole slot's memory.  This module
pages the position axis instead:

  * the pool: every eligible attention layer (``paged_eligible``) holds
    ``pool_pages`` pages of ``page_size`` positions
    (``Attention.init_paged_cache``), and every MLA layer as many pages of
    latent rows (``MLA.init_paged_cache``); page 0 is a reserved trash page —
    writes from emptied slots land there and no block table ever
    references it;
  * the ``PageTable``: host-side free list + per-slot page rows.  A slot's
    page row is the same in every layer, so one (B, max_pages) device block
    table serves the whole cache;
  * allocate-on-demand: ``ensure`` maps each live slot's next write
    positions to pages just before the decode step;
  * free-on-retire: when a slot's lanes have all retired its non-prefix
    pages return to the free list in O(pages) host work, and the recycled
    prefix page's tail is invalidated.  Freed pages are invalidated lazily
    (pos <- -1) when next allocated.

Ineligible layers (a windowed layer whose ring is shorter than
``max_len``, and every Mamba, mLSTM or sLSTM layer, whose recurrent state
is O(1) per slot) keep their contiguous per-slot caches inside the paged
cache: they are imported from the primed template, reset through the same
masked restore as the contiguous allocator's, and their slot slice travels
with a parked slot.  A model with no pooled layer at all (xlstm-125m)
keeps the page table, whose pages then hold no tensor: the counts (peak
pages, slot resets) follow the reference's, and a page is 0 bytes.

The reference updates the pool functionally and donates it; the port
writes it in place, and the prefix chunks and ring templates it restores
from are copies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.backbone import init_cache
from repro_torch.nn.attention import paged_eligible
from repro_torch.serving.kvcache import masked_restore
from repro_torch.serving.telemetry import NULL_TRACER

TRASH_PAGE = 0

# Pool key -> the contiguous template's key it imports from.
_TEMPLATE_KEY = {"k_pages": "k", "v_pages": "v", "ckv_pages": "ckv",
                 "krope_pages": "krope", "pos": "pos"}


def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold positions [0, n_positions)."""
    return -(-n_positions // page_size)


class PageTable:
    """Host-side page bookkeeping: free list + per-slot page rows.

    ``rows[s, j]`` is the pool page holding slot ``s``'s positions
    ``[j*page_size, (j+1)*page_size)``, or -1.  Page 0 is reserved (trash);
    ``usable_pages = pool_pages - 1``.  Allocation within a slot is
    sequential in ``j`` — decode positions grow one at a time — which makes
    slot recycle O(pages) list ops with no search.
    """

    def __init__(self, n_slots: int, pages_per_slot: int, pool_pages: int):
        if pool_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 usable + trash), "
                             f"got {pool_pages}")
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.pool_pages = pool_pages
        # LIFO free list: recently freed pages are reused first (their pool
        # rows are likelier to still be in cache).
        self.free: list[int] = list(range(pool_pages - 1, TRASH_PAGE, -1))
        self.rows = np.full((n_slots, pages_per_slot), -1, np.int32)
        self.n_allocated = np.zeros(n_slots, np.int64)
        self.peak_in_use = 0

    @property
    def usable_pages(self) -> int:
        return self.pool_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self.free)

    def allocate(self, slot: int, page_idx: int) -> int:
        """Map ``rows[slot, page_idx]`` to a fresh pool page."""
        if page_idx >= self.pages_per_slot:
            raise ValueError(
                f"slot {slot} page index {page_idx} exceeds table width "
                f"{self.pages_per_slot} (raise max_len)")
        if self.rows[slot, page_idx] >= 0:
            raise ValueError(f"slot {slot} page {page_idx} already mapped")
        if page_idx != self.n_allocated[slot]:
            raise ValueError(
                f"slot {slot} allocation must be sequential: asked for page "
                f"{page_idx} with {self.n_allocated[slot]} allocated")
        if not self.free:
            raise RuntimeError(
                "page pool exhausted — admission accounting should have "
                "reserved this page")
        pid = self.free.pop()
        self.rows[slot, page_idx] = pid
        self.n_allocated[slot] += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pid

    def free_slot(self, slot: int, *, keep: int = 0) -> list[int]:
        """Return the slot's pages beyond the first ``keep`` (its prefix
        pages) to the free list.  O(1) per page: no compaction, no copies —
        the pool rows themselves are lazily invalidated on reallocation."""
        freed = [int(p) for p in self.rows[slot, keep:] if p >= 0]
        self.free.extend(reversed(freed))
        self.rows[slot, keep:] = -1
        self.n_allocated[slot] = min(self.n_allocated[slot], keep)
        return freed

    def detach_row(self, slot: int) -> tuple[np.ndarray, int]:
        """Park the slot's page row (preempt-and-swap): the pages leave the
        table without being freed — the caller's swap ledger owns them until
        ``attach_row`` — and the slot shows empty.  Host-side O(1): no page
        content moves."""
        row = self.rows[slot].copy()
        n = int(self.n_allocated[slot])
        self.rows[slot] = -1
        self.n_allocated[slot] = 0
        return row, n

    def attach_row(self, slot: int, row: np.ndarray, n_pages: int) -> None:
        """Reattach a detached row into an empty ``slot`` (resume): the
        parked pages come back exactly as parked, on whichever slot index
        was free."""
        if self.n_allocated[slot] or (self.rows[slot] >= 0).any():
            raise ValueError(
                f"slot {slot} still holds pages; free it before attaching "
                f"a parked row")
        self.rows[slot] = row
        self.n_allocated[slot] = n_pages


@dataclasses.dataclass
class PagedPark:
    """Parked cache state of one preempted slot (the swap-ledger payload
    under paging): the detached block-table row — its pool pages stay
    resident, untouched, until resumption — plus a copy of the ineligible
    contiguous layers' slot slice (None when every layer pages)."""
    row: np.ndarray
    n_pages: int
    snapshot: Optional[list] = None


class PagedKVSlotAllocator:
    """Paged counterpart of ``KVSlotAllocator``: owns the page pools plus
    the page table.

    Construction imports the primed ``template`` (from ``Engine.prime``,
    contiguous, full-size or prefix-sized): every slot's prefix K/V is
    written into prefix pages allocated up front and never freed, so a
    recycled slot keeps its prefix resident and skips the prefill; the
    ineligible layers' rings are copied from it.

    Flow: ``ensure`` maps every live slot's write positions to pages just
    before each step; the decode step writes ``.cache`` in place and the
    scheduler hands it back through ``adopt``; ``reset_slots`` recycles
    drained slots.
    """

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 template: Optional[list] = None, page_size: int = 0,
                 pool_pages: int = 0, device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        ps = page_size or cfg.serving.page_size
        self.page_size = ps
        # Telemetry recorder; rebound by ``ContinuousScheduler.set_tracer``.
        self.tracer = NULL_TRACER
        self.pages_per_slot = pages_for(max_len, ps)
        dense = batch * self.pages_per_slot + 1  # + trash page
        self.pool_pages = pool_pages or cfg.serving.pool_pages or dense

        self.prefix_len = cfg.mux.prefix_len
        self.n_prefix_pages = pages_for(self.prefix_len, ps)
        self.table = PageTable(batch, self.pages_per_slot, self.pool_pages)
        if self.table.usable_pages < batch * self.n_prefix_pages + 1:
            raise ValueError(
                f"pool_pages={self.pool_pages} cannot hold "
                f"{batch} slots x {self.n_prefix_pages} prefix pages "
                f"+ 1 working page")
        # Per layer: pooled, or a contiguous per-slot ring.  A model whose
        # every layer is pooled (all MLA, say) parks without a snapshot.
        self._paged = [k["mixer"] in ("attn", "mla") and
                       paged_eligible(k["window"], max_len)
                       for k in cfg.layer_kinds()]
        self._has_contiguous = not all(self._paged)

        if template is None:
            template = init_cache(cfg, batch, max_len,
                                  device=resolve_device(device))
        self.device = next(iter(template[0].values())).device
        self.cache = init_cache(cfg, batch, max_len, device=self.device,
                                page_pool=(self.pool_pages, ps))
        # Reset template of the contiguous layers (None for paged layers,
        # which reset through the page table), padded to the live width
        # when the prime was compact; the live rings start as copies.
        self.template = [None if paged else self._expand(tmpl, live)
                         for paged, tmpl, live in zip(self._paged, template,
                                                      self.cache)]
        for layer, tmpl in zip(self.cache, self.template):
            if tmpl is not None:
                for key, leaf in layer.items():
                    leaf.copy_(tmpl[key])
        # Primed prefix content in page chunks, kept for the life of the
        # allocator: the import below writes every slot's prefix pages from
        # it, and ``park_slot`` re-imports one slot's worth.
        self._prefix_chunks = self._prefix_chunks_from(template)

        for s in range(batch):
            for j in range(self.n_prefix_pages):
                self.table.allocate(s, j)
        self._import(self._rows(self.table.rows[:, :self.n_prefix_pages]))
        # The last prefix page of each slot is partial iff prefix % ps != 0:
        # recycling must re-invalidate its tail, which the drained
        # generation overwrote.
        self._partial_off = self.prefix_len % ps
        self._partial_pages = np.zeros(batch, np.int64)
        self._refresh_partial_pages()
        self._device_table: Optional[torch.Tensor] = None

    def _rows(self, page_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(page_ids, np.int64),
                               device=self.device)

    def _pools(self):
        """The paged layers' pools, with their prefix chunks."""
        return [(layer, ch) for layer, ch, paged in
                zip(self.cache, self._prefix_chunks, self._paged) if paged]

    @staticmethod
    def _expand(tmpl: dict, live: dict) -> dict:
        """A copy of a contiguous layer's primed template, padded to the
        live ring's width: a compact (prefix-sized) prime leaves the rows
        past the prefix unwritten, so zeros (``pos`` -1) reproduce the
        full-size prime bitwise.  A Mamba state, which no prime sizes, is
        copied whole."""
        out = {}
        for key, leaf in tmpl.items():
            full = torch.full_like(live[key], -1 if key == "pos" else 0)
            full[:, :leaf.shape[1]] = leaf
            out[key] = full
        return out

    def _prefix_chunks_from(self, template) -> list[dict]:
        """The primed prefix of every layer as page chunks, slot-major:
        each pool key (B, npp, ps, ...); None for a contiguous layer.
        ``pos`` is padded with -1 past the prefix, so writing a chunk into
        freshly allocated pages also invalidates what their previous owner
        wrote."""
        ps, npp = self.page_size, self.n_prefix_pages
        width = npp * ps
        chunks = []
        for layer, tmpl, paged in zip(self.cache, template, self._paged):
            if not (paged and npp):
                chunks.append(None)
                continue
            ch = {}
            for pool_key, pool in layer.items():
                src = tmpl[_TEMPLATE_KEY[pool_key]]     # (B, S, ...)
                src = src[:, :min(width, src.shape[1])]
                pad = width - src.shape[1]
                if pad:                                 # page wider than cache
                    fill = torch.full(
                        (src.shape[0], pad) + tuple(src.shape[2:]),
                        -1 if pool_key == "pos" else 0, dtype=src.dtype,
                        device=src.device)
                    src = torch.cat([src, fill], dim=1)
                ch[pool_key] = src.reshape(
                    (src.shape[0], npp, ps) + tuple(src.shape[2:])
                ).to(pool.dtype).clone()
            chunks.append(ch)
        return chunks

    # -- in-place pool writes --------------------------------------------------

    def _import(self, prefix_rows: torch.Tensor) -> None:
        """Write the primed prefix chunks into every slot's pre-allocated
        prefix pages (``prefix_rows`` (B, npp))."""
        if not self.n_prefix_pages:
            return
        for layer, ch in self._pools():
            for key, pool in layer.items():
                pool[prefix_rows] = ch[key]

    def _import_slot(self, rows: torch.Tensor, slot: int) -> None:
        """Write one slot's primed prefix chunk into freshly allocated
        prefix pages ``rows`` (npp,): the park-reprovision path."""
        for layer, ch in self._pools():
            for key, pool in layer.items():
                pool[rows] = ch[key][slot]

    def _invalidate(self, page_ids: list[int]) -> None:
        """pos <- -1 on the given pool pages, when freed pages are
        reallocated: the previous owner's K/V is then masked exactly like
        unwritten contiguous rows."""
        idx = self._rows(page_ids)
        for layer, _ in self._pools():
            layer["pos"][idx] = -1

    def _refresh_partial_pages(self) -> None:
        """Re-derive the per-slot partial-prefix-page ids after the table
        changed a slot's prefix row (an empty row maps to the trash page,
        whose tail is never read)."""
        if not (self.n_prefix_pages and self._partial_off):
            return
        last = self.table.rows[:, self.n_prefix_pages - 1]
        self._partial_pages = np.where(last >= 0, last, TRASH_PAGE)

    # -- public API ------------------------------------------------------------

    @property
    def block_table(self) -> torch.Tensor:
        """(B, max_pages) int32 device copy of the page table rows, rebuilt
        only after the table changed."""
        if self._device_table is None:
            self._device_table = torch.tensor(self.table.rows,
                                              device=self.device)
        return self._device_table

    def adopt(self, cache) -> None:
        """Take ownership of the post-step cache."""
        self.cache = cache

    def ensure(self, positions, live_mask, lens=None) -> None:
        """Map every live slot's write range to pages before a decode step.
        ``lens`` (B,) is the number of positions slot s writes this step
        (default 1): chunked prefill covers ``[pos, pos + lens)``, so up to
        ``ceil(chunk / page_size) + 1`` pages per slot may be allocated in
        one call.  Admission accounting guarantees the pool has room."""
        ps = self.page_size
        lens = np.ones(self.batch, np.int64) if lens is None \
            else np.asarray(lens)
        fresh: list[int] = []
        for s in np.nonzero(np.asarray(live_mask))[0]:
            first = int(positions[s]) // ps
            last = (int(positions[s]) + max(1, int(lens[s])) - 1) // ps
            for j in range(first, last + 1):
                if self.table.rows[s, j] < 0:
                    fresh.append(self.table.allocate(s, j))
        if fresh:
            if self.tracer.enabled:
                self.tracer.event("page_alloc", count=len(fresh),
                                  free_after=self.table.free_pages)
            self._invalidate(fresh)
            self._device_table = None

    def reset_slots(self, slot_mask) -> None:
        """Recycle the masked slots: free their non-prefix pages,
        re-invalidate the tail of their partial prefix page (offsets >=
        prefix_len % page_size, which the drained generation overwrote) and
        restore their contiguous rings to the primed template.  Live slots
        are untouched bit-for-bit."""
        mask = np.asarray(slot_mask, bool)
        n_freed = 0
        for s in np.nonzero(mask)[0]:
            n_freed += len(self.table.free_slot(int(s),
                                                keep=self.n_prefix_pages))
        if n_freed and self.tracer.enabled:
            self.tracer.event("page_free", count=n_freed,
                              free_after=self.table.free_pages)
        if self.n_prefix_pages and self._partial_off and mask.any():
            pages = self._rows(self._partial_pages[mask])
            for layer, _ in self._pools():
                layer["pos"][pages, self._partial_off:] = -1
        if self._has_contiguous and mask.any():
            idx = self._rows(np.flatnonzero(mask))
            for layer, tmpl in zip(self.cache, self.template):
                if tmpl is not None:
                    for key, leaf in layer.items():
                        masked_restore(leaf, tmpl[key], idx)
        self._device_table = None

    # -- preempt-and-swap ------------------------------------------------------

    def park_slot(self, slot: int) -> PagedPark:
        """Preempt-and-swap, paged flavour: detach the slot's block-table
        row — its pages stay resident in the pool, owned by the returned
        payload, with no K/V copied — and copy the contiguous rings' slot
        slice; reprovision the slot with fresh prefix pages (content
        re-imported from the primed prefix chunks), so its next occupant
        admits at ``prefix_len`` like a recycled slot (the scheduler resets
        its rings).  Needs ``free_pages >= n_prefix_pages``; the scheduler
        checks before preempting."""
        row, n = self.table.detach_row(slot)
        snap = None
        if self._has_contiguous:
            snap = [None if paged else
                    {k: t[slot:slot + 1].clone() for k, t in layer.items()}
                    for layer, paged in zip(self.cache, self._paged)]
        if self.n_prefix_pages:
            for j in range(self.n_prefix_pages):
                self.table.allocate(slot, j)
            self._import_slot(
                self._rows(self.table.rows[slot, :self.n_prefix_pages]), slot)
            self._refresh_partial_pages()
        self._device_table = None
        return PagedPark(row=row, n_pages=n, snapshot=snap)

    def resume_slot(self, slot: int, payload: PagedPark) -> None:
        """Reattach a parked row into (any) drained slot: the slot's fresh
        prefix pages return to the free list and the parked pages come back
        exactly as parked — a host-side row swap — and the contiguous rings
        take the parked slice, so the resumed group's decode continues
        bit-for-bit."""
        self.table.free_slot(slot, keep=0)
        self.table.attach_row(slot, payload.row, payload.n_pages)
        if payload.snapshot is not None:
            for layer, snap in zip(self.cache, payload.snapshot):
                if snap is not None:
                    for key, leaf in layer.items():
                        leaf[slot:slot + 1] = snap[key]
        self._refresh_partial_pages()
        self._device_table = None

    # -- accounting ------------------------------------------------------------

    def page_bytes(self) -> int:
        """Bytes of one pool page summed across every paged layer."""
        return sum(t.numel() * t.element_size()
                   for layer, _ in self._pools() for t in layer.values()) \
            // self.pool_pages

    def ring_bytes(self) -> int:
        """Bytes of the contiguous layers' per-slot rings."""
        return sum(t.numel() * t.element_size()
                   for layer, paged in zip(self.cache, self._paged)
                   if not paged for t in layer.values())

    def bytes_in_use(self) -> int:
        """Bytes of pages actually allocated, trash page included, plus
        the contiguous rings."""
        return self.ring_bytes() + \
            (self.table.pages_in_use + 1) * self.page_bytes()

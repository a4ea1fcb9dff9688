"""KV cache: slot allocator + bytes accounting — the port of
``repro.serving.kvcache``.

Two halves:

  * ``KVSlotAllocator`` — owns the decode cache (one ``{"k", "v", "pos"}``
    dict per layer, slot axis first) for B backbone slots, each shared by N
    mux lanes, and supports per-slot reset: ``reset_slots(mask)`` restores
    the masked slots to the primed template (prefix K/V for prefix-protocol
    demuxers, zeros otherwise) and leaves live slots bit-for-bit untouched.
  * ``cache_bytes`` / ``paged_cache_bytes`` and their per-stream forms —
    analytic accounting of the bytes ``init_cache`` allocates.

Where the reference donates the live cache into jitted updates, the port
writes it in place.  A template or snapshot that aliased the live cache
would then be overwritten by the next step, so every one of them is a
``clone()``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models.backbone import init_cache
from repro_torch.nn.attention import paged_eligible


def _dtype_bytes(dtype_str: str) -> int:
    return torch_dtype(dtype_str).itemsize


def _layer_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """Bytes of one attention layer's contiguous (per-slot) decode cache."""
    return batch * seq_len * (cfg.n_kv_heads * cfg.head_dim_ * 2
                              * _dtype_bytes(cfg.dtype) + 4)


def cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """Total decode-cache bytes for ``batch`` backbone streams."""
    return cfg.n_layers * _layer_bytes(cfg, batch, seq_len)


def paged_cache_bytes(cfg: ModelConfig, batch: int, max_len: int, *,
                      pool_pages: int, page_size: int) -> int:
    """Bytes of the paged decode cache (``serving/paging.py``): every
    eligible layer holds a shared ``pool_pages``-page pool, trash page
    included.  Pass ``table.pages_in_use + 1`` as ``pool_pages`` to count
    the pages actually allocated."""
    total = 0
    for kind in cfg.layer_kinds():
        if paged_eligible(kind["window"], max_len):
            total += _layer_bytes(cfg, pool_pages, page_size)
        else:
            total += _layer_bytes(cfg, batch, max_len)
    return total


def cache_bytes_per_stream(cfg: ModelConfig, seq_len: int) -> float:
    """Bytes per user stream: one slot's cache divided by the mux.n
    streams that share it."""
    per_slot = cache_bytes(cfg, 1, seq_len + cfg.mux.prefix_len)
    return per_slot / max(1, cfg.mux.n)


def paged_cache_bytes_per_stream(cfg: ModelConfig, seq_len: int, *,
                                 page_size: int) -> float:
    """Paged analogue of ``cache_bytes_per_stream``: one slot holds the
    pages its live tokens occupy (no trash-page share)."""
    total = seq_len + cfg.mux.prefix_len
    pages = -(-total // page_size)
    per_slot = paged_cache_bytes(cfg, 1, total, pool_pages=pages,
                                 page_size=page_size)
    return per_slot / max(1, cfg.mux.n)


def cache_nbytes(cache: list) -> int:
    """Actual bytes of a per-layer cache list."""
    return sum(t.numel() * t.element_size()
               for layer in cache for t in layer.values())


def clone_cache(cache: list) -> list:
    return [{k: t.clone() for k, t in layer.items()} for layer in cache]


# ---------------------------------------------------------------------------
# Slot surgery, in place (slot axis 0 in every contiguous leaf)
# ---------------------------------------------------------------------------

def _slot_index(slot_mask, device) -> torch.Tensor:
    return torch.as_tensor(np.flatnonzero(np.asarray(slot_mask, bool)),
                           device=device)


def _masked_restore(leaf, template, idx) -> None:
    """Slots ``idx`` of ``leaf`` take the template's values."""
    leaf[idx] = template[idx]


def reset_cache_slots(cache, template, slot_mask) -> None:
    """Restore the masked slots of ``cache`` to ``template`` values; the
    other slots are not touched.  ``slot_mask``: (B,) bool."""
    idx = _slot_index(slot_mask, cache[0]["pos"].device)
    for layer, tmpl in zip(cache, template):
        for key, leaf in layer.items():
            _masked_restore(leaf, tmpl[key], idx)


def snapshot_cache_slot(cache, slot: int) -> list:
    """A copy of one slot's slice of every layer: the park half of
    preempt-and-swap.  Copies, so the next in-place step cannot touch it."""
    return [{k: t[slot:slot + 1].clone() for k, t in layer.items()}
            for layer in cache]


def restore_cache_slot(cache, snapshot, slot: int) -> None:
    """Write a ``snapshot_cache_slot`` payload into ``slot`` (any empty
    slot: backbone batch rows are independent); other slots untouched."""
    for layer, snap in zip(cache, snapshot):
        for key, leaf in layer.items():
            leaf[slot:slot + 1] = snap[key].to(leaf.dtype)


class KVSlotAllocator:
    """Owns the decode cache for ``batch`` backbone slots.

    It holds the live cache plus the primed template (one more cache worth
    of memory — the price of O(1) slot recycling).  The engine's decode
    step writes ``.cache`` in place and the caller hands it back through
    ``adopt``; when a slot's lanes have all retired, ``reset_slots`` rewinds
    just that slot to the primed state (prefix K/V, pos -1 elsewhere), so a
    fresh set of requests is admitted at position ``prefix_len``.
    """

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, *,
                 template: Optional[list] = None, device=None):
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        if template is None:
            template = init_cache(cfg, batch, max_len,
                                  device=resolve_device(device))
        self.template = clone_cache(template)
        self.cache = clone_cache(template)

    def adopt(self, cache) -> None:
        """Take ownership of the post-step cache."""
        self.cache = cache

    def reset_slots(self, slot_mask) -> None:
        """Rewind the masked slots to the primed template; live slots are
        untouched bit-for-bit."""
        reset_cache_slots(self.cache, self.template, slot_mask)

    def slot_bytes(self) -> int:
        """Actual bytes of one slot's share of the live cache."""
        return cache_nbytes(self.cache) // max(1, self.batch)

    def park_slot(self, slot: int) -> list:
        """Preempt-and-swap, contiguous flavour: a copy of the whole slot
        region, the swap-ledger payload.  The caller then resets the slot
        for its next occupant."""
        return snapshot_cache_slot(self.cache, slot)

    def resume_slot(self, slot: int, payload) -> None:
        """Restore a parked snapshot into (any) empty ``slot``: the resumed
        group's decode continues bit-for-bit where it was parked."""
        restore_cache_slot(self.cache, payload, slot)

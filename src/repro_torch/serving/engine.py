"""Batched serving engine with first-class data multiplexing — the port of
``repro.serving.engine``.

Flow:  prefill(prompts (B, N, Lp)) -> ServeState{cache, index_embeds, pos}
       step(state, last_tokens (B, N)) -> (logits (B, N, V), state)

Two decode regimes share the same step:

  * lock-step (``generate``): scalar ``pos`` — every slot at the same
    position, the fixed-(B, N) grid.
  * continuous batching (``serving.scheduler``): ``pos`` is a (B,) vector
    and ``lane_mask`` (B, N) marks live lanes, so slots prefill, decode and
    retire independently.  ``prime()`` builds the prefix-primed cache the
    slot allocators reset retired slots back to.

Each step writes the K/V cache in place — the reference donates the cache
to its jitted step for the same effect — so the cache of a ``ServeState``
belongs to the state ``step`` returns: never step a stale state again.

Engine methods run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.models import Backbone
from repro_torch.serving.telemetry import NULL_TRACER


@dataclasses.dataclass
class ServeState:
    cache: list                          # per-layer {"k", "v", "pos"} or
                                         # page pools {"k_pages", ...}
    pos: torch.Tensor                    # int32 next absolute position —
                                         # scalar (lock-step) or (B,)
    index_embeds: Optional[torch.Tensor]  # (B, N, d) for prefix-protocol
                                          # demux strategies, else None


class Engine:
    def __init__(self, model: Backbone, *, batch: int, max_len: int):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.max_len = max_len + self.cfg.mux.prefix_len
        self.device = model.device
        # Telemetry recorder (serving/telemetry.py); the scheduler's
        # ``set_tracer`` rebinds it.
        self.tracer = NULL_TRACER
        chunk = self.cfg.serving.prefill_chunk
        if chunk > self.max_len:
            # C distinct cache rows per chunk (the dense family has no
            # window rings, so the cache itself is the smallest ring).
            raise ValueError(
                f"serving.prefill_chunk={chunk} exceeds the smallest cache "
                f"ring ({self.max_len} slots); shrink the chunk")
        self._validate_serving_policy(self.cfg)
        # Width-class variants (``variant``): built lazily, cached by
        # (width, batch), counted for telemetry.
        self._variants: dict[tuple[int, int], "Engine"] = {}
        self.variant_compiles = 0

    @staticmethod
    def _validate_serving_policy(cfg) -> None:
        """Fail fast on a mistyped admission policy name at construction.
        The preempt / eviction pairing is checked by the scheduler, which
        alone knows whether an explicit ``eviction=`` override applies."""
        from repro_torch.serving import policies as serving_policies
        slo = serving_policies.SloClasses(cfg.serving.slo_classes)
        serving_policies.resolve("admission", cfg.serving.policy, slo)

    @torch.inference_mode()
    def prefill(self, prompts) -> tuple[torch.Tensor, ServeState]:
        """prompts: (B, N, Lp) muxed or (B, Lp).  Returns (last-token
        logits, state)."""
        tokens = torch.as_tensor(prompts, device=self.device)
        cache = self.model.init_cache(self.batch, self.max_len)
        out = self.model(tokens, cache=cache, last_only=True)
        lp = tokens.shape[-1] + self.cfg.mux.prefix_len
        pos = torch.tensor(lp, dtype=torch.int32, device=self.device)
        return out["logits"][..., -1, :], ServeState(
            cache=out["cache"], pos=pos, index_embeds=out["index_embeds"])

    @torch.inference_mode()
    def prime(self, *, compact: bool = False) -> ServeState:
        """Prefix-primed state for continuous batching: the cache holds only
        the demux prefix's K/V, ``pos`` is a (B,) vector at ``prefix_len``.
        With a non-prefix demux (or mux inactive) the cache is fresh and
        ``pos`` starts at 0.

        The prefix runs through the backbone with no content tokens, so for
        a causal model the primed state is input-independent and the slot
        allocators reset retired slots back to it without a prefill.

        ``compact``: prime a prefix-sized cache (width ``prefix_len``, or 1
        without a prefix) instead of a ``max_len`` one; the prefix K/V are
        bitwise the same, and the paged allocator imports its prefix pages
        from it without a dense (B, max_len) transient."""
        cfg = self.cfg
        p = cfg.mux.prefix_len
        if cfg.mux.active and p:
            cache = self.model.init_cache(self.batch,
                                          p if compact else self.max_len)
            empty = torch.zeros((self.batch, cfg.mux.n, 0), dtype=torch.int32,
                                device=self.device)
            out = self.model(empty, cache=cache, last_only=True)
            cache, index_embeds = out["cache"], out["index_embeds"]
        else:
            cache = self.model.init_cache(self.batch,
                                          1 if compact else self.max_len)
            index_embeds = None
        pos = torch.full((self.batch,), p, dtype=torch.int32,
                         device=self.device)
        return ServeState(cache=cache, pos=pos, index_embeds=index_embeds)

    def variant(self, width: int, batch: int) -> "Engine":
        """Width-class serving variant: an engine serving ``batch`` slots at
        mux width ``width`` <= cfg.mux.n over this engine's backbone weights
        with narrowed mux/demux params (``Backbone.narrowed``).  Built
        lazily and cached by (width, batch); the native pair returns
        ``self``."""
        if width == self.cfg.mux.n and batch == self.batch:
            return self
        key = (width, batch)
        if key not in self._variants:
            self._variants[key] = self._build_variant(width, batch)
            self.variant_compiles += 1
        return self._variants[key]

    def _build_variant(self, width: int, batch: int) -> "Engine":
        serve_len = self.max_len - self.cfg.mux.prefix_len
        eng = Engine(self.model.narrowed(width), batch=batch,
                     max_len=serve_len)
        eng.tracer = self.tracer
        return eng

    @torch.inference_mode()
    def step(self, state: ServeState, tokens, lane_mask=None,
             block_table=None, chunk_lens=None
             ) -> tuple[torch.Tensor, ServeState]:
        """One decode step at ``state.pos``; ``lane_mask`` (B, N) masks
        retired lanes out of the mixed stream and the logits;
        ``block_table`` (B, max_pages) routes a paged cache's writes and
        reads (``serving/paging.py``).

        Chunked prefill: with ``chunk_lens`` (B,), ``tokens`` carries a
        trailing chunk axis (B, N, C) / (B, C), ``lane_mask`` is (B, N, C),
        and slot b advances ``chunk_lens[b]`` positions; logits come back
        per chunk row."""
        if lane_mask is not None:
            lane_mask = torch.as_tensor(lane_mask, device=self.device)
        pos = torch.as_tensor(state.pos, dtype=torch.int32, device=self.device)
        advance = 1
        if chunk_lens is not None:
            chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int32,
                                         device=self.device)
            advance = chunk_lens
        t0 = time.perf_counter() if self.tracer.enabled else 0.0
        logits, cache = self.model.decode_step(
            torch.as_tensor(tokens, device=self.device), state.cache, pos,
            index_embeds=state.index_embeds, lane_mask=lane_mask,
            block_table=block_table, chunk_lens=chunk_lens)
        if self.tracer.enabled:
            # Host wall-clock of the step's dispatch: the device runs
            # asynchronously and is not waited for here.
            self.tracer.event("engine_step",
                              wall_ms=(time.perf_counter() - t0) * 1e3)
        return logits, dataclasses.replace(state, cache=cache,
                                           pos=pos + advance)

    @torch.inference_mode()
    def generate(self, prompts, steps: int):
        """Greedy generation for all (B, N) streams at once.  Returns tokens
        (B, N, steps + 1) or (B, steps + 1)."""
        logits, state = self.prefill(prompts)
        toks = []
        last = logits.argmax(dim=-1)
        for _ in range(steps):
            toks.append(last)
            logits, state = self.step(state, last)
            last = logits.argmax(dim=-1)
        toks.append(last)
        return torch.stack(toks, dim=-1)

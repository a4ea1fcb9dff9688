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

Each step writes the cache in place (K/V, MLA latents, Mamba states) —
the reference donates the cache to its jitted step for the same effect —
so the cache of a ``ServeState`` belongs to the state ``step`` returns:
never step a stale state again.

The engine serves every family the port runs: attention and MLA layers
write K/V or latent rows, Mamba and xLSTM layers advance an O(1)
recurrent state (prefill runs the full scan, whose final state fills the
cache).  A cross-attention config takes a ``context``, which ``prefill``
encodes once (``Backbone.encode_context``); its K/V ride in the state
through every step.  As in the reference, ``prime`` encodes a context but
runs the demux prefix without it, so continuous batching refuses a cross
config with a prefix demux.
Chunked prefill (``prefill_chunk > 1``) takes every one of them: attention
and MLA caches mask their row writes and Mamba gates its recurrence per
row; an xLSTM mixer, which has no row-gated state update, is refused.

On a mesh (``Engine(mesh=, mesh_info=)``), lock-step serving splits the
slots: ``prefill`` keeps this rank's rows (``sharding.placement.batch_rows``
over the axes ``MeshInfo.bl_entries`` gives the batch; another axis, and
the model axis, run the same rows on every rank) of the prompts and the
context, and their cache; ``step`` feeds that state this rank's rows of
the tokens; both all-gather the logits, so every rank returns what one
process returns.  The parameters are replicated, as the reference's
launcher leaves them.  The continuous scheduler, the paged pool and the
router build their states with ``prime``, which is not split: on a mesh
every rank runs all their rows (splitting their slots across ranks is a
later ROADMAP item).  Every model call gets the mesh, so an MoE layer
runs the reference's expert-parallel block: on the rank's rows of a
lock-step state, and on a primed state's whole batch, of which it takes
the rank's shard (``MoE.forward``), so that each shard's capacity is
the reference's.  Experts the mesh cannot split evenly raise
(``nn.moe.check_mesh``).

Engine methods run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.models import Backbone
from repro_torch.nn.attention import cache_rows
from repro_torch.nn.moe import SINGLE, MeshInfo, OnMesh, check_model_mesh
from repro_torch.serving.telemetry import NULL_TRACER


@dataclasses.dataclass
class ServeState:
    cache: list                          # per-layer {"k", "v", "pos"},
                                         # MLA {"ckv", "krope", "pos"},
                                         # Mamba {"ssm", "conv"} or
                                         # page pools {"k_pages", ...}
    pos: torch.Tensor                    # int32 next absolute position —
                                         # scalar (lock-step) or (B,)
    index_embeds: Optional[torch.Tensor]  # (B, N, d) for prefix-protocol
                                          # demux strategies, else None
    cross_kv: Optional[dict] = None      # {layer: {"k", "v"}} of the
                                         # context (cross configs)
    rows: Optional[slice] = None         # the batch rows this rank holds
                                         # (lock-step on a mesh), else all


class Engine:
    def __init__(self, model: Backbone, *, batch: int, max_len: int,
                 mesh=None, mesh_info: MeshInfo = SINGLE):
        if mesh is not None:
            check_model_mesh(model.cfg, mesh_info)
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.max_len = max_len + self.cfg.mux.prefix_len
        self.device = model.device
        self.mesh = mesh
        self.mesh_info = mesh_info
        self._rows, self._axes = slice(0, batch), ()
        if mesh is not None:
            from repro_torch.sharding.placement import batch_rows
            self._rows, self._axes = batch_rows(mesh, mesh_info, batch,
                                                self.max_len)
        # Telemetry recorder (serving/telemetry.py); the scheduler's
        # ``set_tracer`` rebinds it.
        self.tracer = NULL_TRACER
        chunk = self.cfg.serving.prefill_chunk
        kinds = self.cfg.layer_kinds()
        # xLSTM state updates have no row-gated form (as in the reference).
        bad = sorted({k["mixer"] for k in kinds
                      if k["mixer"] in ("mlstm", "slstm")})
        if chunk > 1 and bad:
            raise ValueError(
                f"serving.prefill_chunk={chunk} unsupported with {bad} "
                f"mixers (xLSTM has no row-masked state update); set "
                f"prefill_chunk=1")
        # A chunk writes C distinct rows of every cache: at most the
        # smallest ring (a windowed layer's, else the cache itself).
        slots = min(cache_rows(k["window"], self.max_len) for k in kinds)
        if chunk > slots:
            raise ValueError(
                f"serving.prefill_chunk={chunk} exceeds the smallest cache "
                f"ring ({slots} slots); shrink the chunk")
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
    def prefill(self, prompts, context=None
                ) -> tuple[torch.Tensor, ServeState]:
        """prompts: (B, N, Lp) muxed or (B, Lp).  Returns (last-token
        logits, state).  ``context`` (B, Lc, context_dim) is encoded
        exactly once here; its K/V serve the prefill and every step."""
        tokens = torch.as_tensor(prompts, device=self.device)
        rows = self._rows
        if self.mesh is not None:
            tokens = tokens[rows]
            context = None if context is None else context[rows]
        on_mesh = self._on_mesh(split=True)
        cross_kv = self._encode(context, on_mesh)
        cache = self.model.init_cache(rows.stop - rows.start, self.max_len)
        out = self.model(tokens, cross_kv=cross_kv, cache=cache,
                         last_only=True, on_mesh=on_mesh)
        lp = tokens.shape[-1] + self.cfg.mux.prefix_len
        pos = torch.tensor(lp, dtype=torch.int32, device=self.device)
        return self._gather(out["logits"][..., -1, :]), ServeState(
            cache=out["cache"], pos=pos, index_embeds=out["index_embeds"],
            cross_kv=cross_kv, rows=rows if self.mesh is not None else None)

    def _gather(self, logits):
        """This rank's rows of the logits -> every row (on a mesh)."""
        if not self._axes:
            return logits
        from repro_torch.sharding.placement import gather_rows
        return gather_rows(logits, self.mesh, self._axes)

    def _on_mesh(self, split: bool) -> Optional[OnMesh]:
        """The model's mesh: the batch rows this rank's (``split``,
        lock-step) or all of them (a primed state)."""
        if self.mesh is None:
            return None
        return OnMesh(self.mesh, self.mesh_info,
                      self._axes if split else ())

    def _encode(self, context, on_mesh: Optional[OnMesh]):
        if context is None:
            return None
        ctx = torch.as_tensor(context, device=self.device)
        # without a mesh, the call one process makes
        return self.model.encode_context(ctx) if on_mesh is None \
            else self.model.encode_context(ctx, on_mesh=on_mesh)

    @torch.inference_mode()
    def prime(self, context=None, *, compact: bool = False) -> ServeState:
        """Prefix-primed state for continuous batching: the cache holds only
        the demux prefix's K/V (and a Mamba layer the state after the
        prefix), ``pos`` is a (B,) vector at ``prefix_len``.
        With a non-prefix demux (or mux inactive) the cache is fresh and
        ``pos`` starts at 0.

        The prefix runs through the backbone with no content tokens, so for
        a causal model the primed state is input-independent and the slot
        allocators reset retired slots back to it without a prefill.

        ``compact``: prime a prefix-sized cache (width ``prefix_len``, or 1
        without a prefix) instead of a ``max_len`` one; the prefix K/V are
        bitwise the same, and the paged allocator imports its prefix pages
        from it without a dense (B, max_len) transient.

        ``context`` is encoded into the state's ``cross_kv``, but the
        prefix runs without it, as in the reference: a cross layer then
        refuses the prefix."""
        cfg = self.cfg
        on_mesh = self._on_mesh(split=False)
        cross_kv = self._encode(context, on_mesh)
        p = cfg.mux.prefix_len
        if cfg.mux.active and p:
            cache = self.model.init_cache(self.batch,
                                          p if compact else self.max_len)
            empty = torch.zeros((self.batch, cfg.mux.n, 0), dtype=torch.int32,
                                device=self.device)
            out = self.model(empty, cache=cache, last_only=True,
                             on_mesh=on_mesh)
            cache, index_embeds = out["cache"], out["index_embeds"]
        else:
            cache = self.model.init_cache(self.batch,
                                          1 if compact else self.max_len)
            index_embeds = None
        pos = torch.full((self.batch,), p, dtype=torch.int32,
                         device=self.device)
        return ServeState(cache=cache, pos=pos, index_embeds=index_embeds,
                          cross_kv=cross_kv)

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
                     max_len=serve_len, mesh=self.mesh,
                     mesh_info=self.mesh_info)
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
        tokens = torch.as_tensor(tokens, device=self.device)
        if lane_mask is not None:
            lane_mask = torch.as_tensor(lane_mask, device=self.device)
        if state.rows is not None:
            tokens = tokens[state.rows]
            if lane_mask is not None:
                lane_mask = lane_mask[state.rows]
        pos = torch.as_tensor(state.pos, dtype=torch.int32, device=self.device)
        advance = 1
        if chunk_lens is not None:
            chunk_lens = torch.as_tensor(chunk_lens, dtype=torch.int32,
                                         device=self.device)
            advance = chunk_lens
        t0 = time.perf_counter() if self.tracer.enabled else 0.0
        logits, cache = self.model.decode_step(
            tokens, state.cache, pos,
            index_embeds=state.index_embeds, cross_kv=state.cross_kv,
            lane_mask=lane_mask, block_table=block_table,
            chunk_lens=chunk_lens,
            on_mesh=self._on_mesh(split=state.rows is not None))
        if self.tracer.enabled:
            # Host wall-clock of the step's dispatch: the device runs
            # asynchronously and is not waited for here.
            self.tracer.event("engine_step",
                              wall_ms=(time.perf_counter() - t0) * 1e3)
        if state.rows is not None:
            logits = self._gather(logits)
        return logits, dataclasses.replace(state, cache=cache,
                                           pos=pos + advance)

    @torch.inference_mode()
    def generate(self, prompts, steps: int, *, context=None):
        """Greedy generation for all (B, N) streams at once, over
        ``context`` for a cross config.  Returns tokens (B, N, steps + 1)
        or (B, steps + 1)."""
        logits, state = self.prefill(prompts, context=context)
        toks = []
        last = logits.argmax(dim=-1)
        for _ in range(steps):
            toks.append(last)
            logits, state = self.step(state, last)
            last = logits.argmax(dim=-1)
        toks.append(last)
        return torch.stack(toks, dim=-1)

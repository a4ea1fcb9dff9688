"""Batched serving engine with first-class data multiplexing — the
lock-step part of ``repro.serving.engine``.

Flow:  prefill(prompts (B, N, Lp)) -> ServeState{cache, index_embeds, pos}
       step(state, last_tokens (B, N)) -> (logits (B, N, V), state)

``pos`` is a scalar (every slot at the same position: the lock-step grid)
or a (B,) vector (each slot at its own position).  Each step writes the
K/V cache in place — the reference donates the cache to its jitted step
for the same effect — so the cache of a ``ServeState`` belongs to the
state ``step`` returns: never step a stale state again.

Engine methods run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import Backbone


@dataclasses.dataclass
class ServeState:
    cache: list                          # per-layer {"k", "v", "pos"}
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
    def step(self, state: ServeState, tokens, lane_mask=None
             ) -> tuple[torch.Tensor, ServeState]:
        """One decode step at ``state.pos``; ``lane_mask`` (B, N) masks
        retired lanes out of the mixed stream and the logits."""
        if lane_mask is not None:
            lane_mask = torch.as_tensor(lane_mask, device=self.device)
        logits, cache = self.model.decode_step(
            torch.as_tensor(tokens, device=self.device), state.cache,
            state.pos, index_embeds=state.index_embeds, lane_mask=lane_mask)
        return logits, dataclasses.replace(state, cache=cache,
                                           pos=state.pos + 1)

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

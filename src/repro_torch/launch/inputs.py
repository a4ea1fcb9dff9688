"""Meta-tensor stand-ins for every model input — the port of
``repro.launch.inputs``: the reference's shapes and dtypes, no storage
(``device="meta"``), where the reference gives ``ShapeDtypeStruct``s.

The DataMUX batch convention (paper semantics): an input shape's
``global_batch`` counts INSTANCES; with multiplexing N, the backbone sees
``B = ceil(global_batch / N)`` mixed streams.  ``decode`` shapes run one
decode step — ONE new token against a ``seq_len`` cache — never a train
step.

The cache is the port's per-layer list (``models.backbone.init_cache``)
and the cross-attention K/V its ``{layer index: {"k", "v"}}``
(``Backbone.encode_context``), where the reference stacks its scanned
layers; every tensor in them has the reference's per-layer shape.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.strategies import get_demux
from repro_torch.models import Backbone

META = torch.device("meta")


def backbone_batch(cfg: ModelConfig, shape: ShapeConfig) -> int:
    n = max(cfg.mux.n, 1)
    return max(1, math.ceil(shape.global_batch / n))


def token_struct(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    b = backbone_batch(cfg, shape)
    if cfg.mux.active:
        return torch.empty((b, cfg.mux.n, shape.seq_len), dtype=torch.int32,
                           device=META)
    return torch.empty((b, shape.seq_len), dtype=torch.int32, device=META)


def context_struct(cfg: ModelConfig, shape: ShapeConfig):
    if not cfg.context_len:
        return None
    b = backbone_batch(cfg, shape)
    return torch.empty((b, cfg.context_len, cfg.context_dim),
                       dtype=cfg.compute_dtype, device=META)


def train_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    batch = {"tokens": token_struct(cfg, shape)}
    ctx = context_struct(cfg, shape)
    if ctx is not None:
        batch["context"] = ctx
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    return train_inputs(cfg, shape)


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, *,
                  len_multiple: int = 256, model: Backbone | None = None
                  ) -> dict[str, Any]:
    """One decode step's operands: one token per stream and a ``seq_len``
    cache.

    max_len is rounded up to ``len_multiple``, as the reference rounds it
    (there, so that the cache's sequence dim can shard over the mesh).
    ``cross_kv`` (a cross config) is ``model``'s ``encode_context`` of the
    context; ``model`` defaults to ``param_struct(cfg)``.
    """
    b = backbone_batch(cfg, shape)
    n = cfg.mux.n
    max_len = shape.seq_len + cfg.mux.prefix_len
    max_len += -max_len % len_multiple
    model = model if model is not None else param_struct(cfg)
    out = {
        "tokens": torch.empty((b, n) if cfg.mux.active else (b,),
                              dtype=torch.int32, device=META),
        "cache": model.init_cache(b, max_len, cfg.compute_dtype),
        "pos": torch.empty((), dtype=torch.int32, device=META),
    }
    if cfg.mux.active and get_demux(cfg.mux.demux).uses_prefix:
        out["index_embeds"] = torch.empty((b, n, cfg.d_model),
                                          dtype=cfg.compute_dtype,
                                          device=META)
    ctx = context_struct(cfg, shape)
    if ctx is not None:
        # cross-attn K/V are computed once per request
        with torch.no_grad():
            out["cross_kv"] = model.encode_context(ctx)
    return out


def state_struct(cfg: ModelConfig, tcfg) -> dict:
    """The whole train state on ``meta``: the model, the task head (cls /
    tag) and the AdamW moments with their step, as ``Trainer``'s first
    step adds them."""
    from repro_torch.training.trainer import Trainer
    state = Trainer.init_state(cfg, tcfg, device=META)
    state["opt_state"] = Trainer.make_optimizer(tcfg).init(
        Trainer.params(state))
    state["step"] = 0
    return state


def param_struct(cfg: ModelConfig) -> Backbone:
    """The model on ``meta``: every parameter's shape and dtype, none
    drawn."""
    return Backbone(cfg, device=META)

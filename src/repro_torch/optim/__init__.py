"""Optimizer substrate — the port of ``repro.optim``: AdamW, schedules and
global-norm clipping as plain functions on dicts of tensors."""
from repro_torch.optim.adamw import AdamW, apply_updates
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant, linear_warmup_cosine

__all__ = ["AdamW", "apply_updates", "constant", "linear_warmup_cosine",
           "clip_by_global_norm", "global_norm"]

"""Shared set-up of the parity tests between the JAX package (``repro``,
the reference) and its PyTorch port (``repro_torch``): one config built in
both packages, weights initialised in JAX and carried over by the bridge,
inputs drawn with numpy from a seed."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import Backbone as JaxBackbone
from repro_torch.bridge import params_from_jax
from repro_torch.configs import base as torch_base
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.models import Backbone as TorchBackbone

# The parity tests' model: 2 layers, d=64, 4 heads, vocab 128, float32.
SMALL = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128)
ARCHS = {
    # the paper's T-MUX: bidirectional, LayerNorm, GELU, tied embedding
    "tmux": ("tmux-12l-768h", dict(n_kv_heads=4)),
    # a causal dense decoder: RMSNorm, SwiGLU, QKV bias, GQA, untied head
    "qwen": ("qwen1.5-4b", dict(n_kv_heads=2)),
}


def configs(arch: str, n: int, *, mux: dict | None = None,
            serving: dict | None = None):
    """(jax cfg, torch cfg): the arch's smoke config cut to ``SMALL``."""
    name, extra = ARCHS[arch]
    out = []
    for smoke, pkg in ((jax_smoke, jax_base), (torch_smoke, torch_base)):
        cfg = smoke(name, mux_n=n)
        kw = dict(SMALL, **extra)
        kw["mux"] = dataclasses.replace(cfg.mux, **(mux or {}))
        kw["serving"] = pkg.ServingConfig(**(serving or {}))
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


def bridged(jcfg, tcfg, seed: int = 0):
    """(jax params, torch Backbone on the CPU with the same weights)."""
    params = JaxBackbone.init(jax.random.PRNGKey(seed), jcfg)
    model = TorchBackbone(tcfg, device="cpu")
    model.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params), tcfg), strict=True)
    return params, model.eval()


def tokens(cfg, b: int, length: int, seed: int = 0) -> np.ndarray:
    n = cfg.mux.n
    shape = (b, n, length) if cfg.mux.active else (b, length)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def as_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a.copy())

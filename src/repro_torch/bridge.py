"""Weight and cache bridge: the JAX package's param pytree -> a
``Backbone`` state_dict, and its decode-cache pytree -> the port's
per-layer cache list.

The input is the reference's param tree with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)``), so this module needs neither
JAX nor the reference package.  Mapping:

  * ``head_layers[i]``, scanned ``blocks[j][...][g]`` and
    ``tail_layers[t]`` become ``layers.{i}``: with ``head`` unscanned layers
    and a pattern of ``period`` layers scanned over ``groups``, layer
    ``head + g * period + j`` reads ``blocks[j][leaf][g]``;
  * a Linear ``{"w": (in, out), "b"}`` becomes ``weight`` (out, in) and
    ``bias`` (a stacked ``w`` of shape (N, in, out), as the "mlp" demux
    keeps it, becomes (N, out, in));
  * every other leaf keeps its name and value (``embed.table``,
    ``mux.v``, ``demux.prefix_table``, norm ``scale``/``bias``, ...).

A tied embedding stays tied: the reference then has no ``lm_head`` and
neither does the state_dict.

A cache pytree has the same head / scanned blocks / tail split, with one
dict of leaves per layer (``k``/``v``/``pos`` contiguous, or
``k_pages``/``v_pages``/``pos`` paged); ``cache_from_jax`` splits it into
one such dict of tensors per layer, in layer order.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes.bfloat16
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if "w" in tree and set(tree) <= {"w", "b"}:          # Linear
            out[prefix + "weight"] = _tensor(np.swapaxes(tree["w"], -1, -2))
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
            return
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def _layers(head, blocks, tail, cfg, what: str) -> list:
    """Per-layer trees in layer order: layer ``head + g * period + j``
    reads ``blocks[j][leaf][g]``."""
    period = len(blocks)
    groups = np.asarray(_first_leaf(blocks[0])).shape[0] if blocks else 0
    layers = list(head)
    layers += [None] * (period * groups)
    for j, block in enumerate(blocks):
        for g in range(groups):
            layers[len(head) + g * period + j] = _index(block, g)
    layers += tail
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{what} tree has {len(layers)} layers, config "
                         f"{cfg.name!r} has {cfg.n_layers}")
    return layers


def params_from_jax(np_params: dict, cfg) -> dict[str, torch.Tensor]:
    """Reference param tree (numpy leaves) -> ``Backbone(cfg)`` state_dict
    (CPU tensors; ``load_state_dict`` copies them to the model's device and
    keeps the model's dtype)."""
    layers = _layers(np_params.get("head_layers", []),
                     np_params.get("blocks", []),
                     np_params.get("tail_layers", []), cfg, "param")

    out: dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "lm_head", "mux", "demux"):
        if name in np_params:
            _flatten(np_params[name], name + ".", out)
    for i, layer in enumerate(layers):
        _flatten(layer, f"layers.{i}.", out)
    return out


def cache_from_jax(np_cache: dict, cfg) -> list[dict[str, torch.Tensor]]:
    """Reference decode cache ({"head", "blocks", "tail"}, numpy leaves,
    contiguous or paged) -> the port's per-layer cache list (CPU tensors,
    the reference's dtypes)."""
    layers = _layers(np_cache["head"], np_cache["blocks"], np_cache["tail"],
                     cfg, "cache")
    return [{k: _tensor(v) for k, v in layer.items()} for layer in layers]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree

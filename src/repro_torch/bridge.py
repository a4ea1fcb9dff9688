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
  * an mLSTM layer's Linears sit under ``mlstm`` (``up``, ``wq``, ``wk``,
    ``wv``, ``wi``, ``wf``, ``wo``, ``down``), an sLSTM layer's raw ``wx``,
    ``wr`` and ``b`` under ``slstm``, its gated FFN's Linears under
    ``slstm.ffn``;
  * every other leaf keeps its name and value (``embed.table``,
    ``mux.v``, ``demux.prefix_table``, norm ``scale``/``bias``, an MoE
    layer's expert stacks ``moe.up`` / ``moe.gate`` (E, d, f) and
    ``moe.down`` (E, f, d), ...); an MLA layer's six Linears sit under
    ``attn`` as an attention layer's four do (``attn.wq_a``, ``wq_b``,
    ``wkv_a``, ``wk_b``, ``wv_b``, ``wo``); a Mamba layer's leaves sit
    under ``mamba`` (``mamba.in_proj``, ``x_proj``, ``dt_proj`` (with its
    bias) and ``out_proj`` are Linears; ``conv_w`` (d_conv, d_inner),
    ``conv_b``, ``A_log`` (d_inner, d_state) and ``D`` keep their names and
    layouts); an MoE router ``{"w": (d, E)}`` is a Linear like any other
    (``moe.router.weight`` (E, d)) and keeps its float32; a cross layer's
    ``norm_x``, ``cross`` (``wq``, ``wk``, ``wv``, ``wo``) and its scalar
    ``cross_gate`` (one entry of the scanned ``(groups,)`` array) keep
    their names;
  * an encoder stack ``{"layers": [...], "final_norm"}`` becomes
    ``encoder.layers.{i}`` and ``encoder.final_norm``.

A tied embedding stays tied: the reference then has no ``lm_head`` and
neither does the state_dict.  A trainer's task head ``{"w": (d,
n_classes)}`` (cls/tag tasks) is not a backbone weight: it becomes
``task_head.w`` in the reference's layout, for ``Trainer.load_params``.

A cache pytree has the same head / scanned blocks / tail split, with one
dict of leaves per layer (``k``/``v``/``pos`` contiguous, or
``k_pages``/``v_pages``/``pos`` paged; an MLA layer's ``ckv``/``krope``/
``pos`` or ``ckv_pages``/``krope_pages``/``pos``; a Mamba layer's ``ssm``
(float32) / ``conv``, an mLSTM layer's ``C`` / ``n`` / ``m`` and an sLSTM
layer's ``c`` / ``n`` / ``m`` / ``h`` (float32), contiguous in either
layout); ``cache_from_jax``
splits it into one such dict of tensors per layer, in layer order.
``cross_kv_from_jax`` maps the context K/V of the reference's
``encode_context`` ({"head": {i}, "blocks": {j}, "tail": {t}}, a scanned
entry stacked over groups) onto the port's {layer index: {"k", "v"}}.

An optimizer state ``{"mu", "nu", "step"}`` holds trees of the params'
structure, so ``opt_state_from_jax`` maps its moments as params.  Leaves
may also be CPU tensors (``checkpoint.read_reference_checkpoint`` gives
those, numpy having no bfloat16).

``reference_paths`` inverts the param mapping: per port tensor name, the
reference's key path (``head_layers/i/...``, ``blocks/j/...`` or
``tail_layers/t/...``, ``w`` for ``weight`` and ``b`` for a Linear's
``bias``), whether the reference stacks it over groups and whether its
last two axes are swapped.  ``sharding.specs`` matches the reference's
placement rules on those paths.

``decay_mask`` gives, per port tensor name, the reference AdamW's
weight-decay decision, which it takes on its own tree layout.

``image_params_from_jax`` maps the reference's image-model tree
(``repro.models.image``: raw matrices and HWIO convolutions, the mux
strategy's leaves under ``mux``) onto ``MuxMLP`` / ``MuxCNN``, every leaf
under its own name and layout.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes.bfloat16
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if "w" in tree and set(tree) <= {"w", "b"}:          # Linear
            out[prefix + "weight"] = _tensor(tree["w"].swapaxes(-1, -2))
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
    return tree[g]


def _layers(head, blocks, tail, cfg, what: str) -> list:
    """Per-layer trees in layer order: layer ``head + g * period + j``
    reads ``blocks[j][leaf][g]``."""
    period = len(blocks)
    groups = _first_leaf(blocks[0]).shape[0] if blocks else 0
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
    keeps the model's dtype), plus ``task_head.w`` when the tree has a
    task head."""
    layers = _layers(np_params.get("head_layers", []),
                     np_params.get("blocks", []),
                     np_params.get("tail_layers", []), cfg, "param")

    out: dict[str, torch.Tensor] = {}
    for name in ("embed", "final_norm", "lm_head", "mux", "demux"):
        if name in np_params:
            _flatten(np_params[name], name + ".", out)
    for i, layer in enumerate(layers):
        _flatten(layer, f"layers.{i}.", out)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        for i, layer in enumerate(enc["layers"]):
            _flatten(layer, f"encoder.layers.{i}.", out)
        _flatten(enc["final_norm"], "encoder.final_norm.", out)
    if "task_head" in np_params:
        out["task_head.w"] = _tensor(np_params["task_head"]["w"])
    return out


def reference_paths(cfg, names) -> dict[str, tuple[str, bool, bool]]:
    """Per port tensor name (``names``: the ``Trainer.params`` names, or any
    iterable of ``params_from_jax`` names): (the reference's key path,
    stacked, transposed), the inverse of ``params_from_jax``.  Layer ``i``
    is ``head_layers/i`` below ``head``, ``blocks/j`` with ``j = (i -
    head) % period`` over the scanned groups (stacked: the reference's leaf
    has a leading (groups,) axis), else ``tail_layers/t``; a Linear's
    ``weight`` is ``w`` with its last two axes swapped (a per-index demux
    weight (N, out, in) too) and its ``bias`` is ``b``; every other part of
    the name is a key of the path as it stands (``mlstm``, ``slstm.ffn``,
    ``encoder.layers.i``, ``task_head.w``, a norm's ``bias``, ...)."""
    head, period, groups = cfg.layer_pattern()
    names = list(names)
    linears = {n.rsplit(".", 1)[0] for n in names if n.endswith(".weight")}
    out = {}
    for name in names:
        owner, leaf = name.rsplit(".", 1)
        parts = name.split(".")
        stacked = False
        if parts[0] == "layers":
            i = int(parts[1])
            if i < head:
                where = ["head_layers", str(i)]
            elif i < head + period * groups:
                where, stacked = ["blocks", str((i - head) % period)], True
            else:
                where = ["tail_layers", str(i - head - period * groups)]
            parts = where + parts[2:]
        transposed = leaf == "weight"
        if transposed:
            parts[-1] = "w"
        elif leaf == "bias" and owner in linears:
            parts[-1] = "b"
        out[name] = ("/".join(parts), stacked, transposed)
    return out


def opt_state_from_jax(np_opt_state: dict, cfg) -> dict:
    """Reference AdamW state {"mu", "nu": param trees, "step"} -> the port's
    {"mu", "nu": ``params_from_jax`` names -> tensors, "step": int}."""
    return {"mu": params_from_jax(np_opt_state["mu"], cfg),
            "nu": params_from_jax(np_opt_state["nu"], cfg),
            "step": int(np_opt_state["step"])}


def decay_mask(cfg, params) -> dict[str, bool]:
    """Per port tensor name (``params`` maps names to tensors or shapes):
    whether the reference's AdamW decays it.  The reference decays a leaf
    iff ``ndim >= 2`` in its own tree, where every layer of the scanned
    pattern (``cfg.layer_pattern()``) has its params stacked over groups,
    one axis more than the port's.  So a scanned layer's norm ``scale`` /
    ``bias`` and Linear ``bias`` are decayed, an unscanned layer's are not,
    nor ``final_norm``'s nor any ``cross_gate`` (a scalar, or a
    ``(groups,)`` vector when scanned); the encoder's layers are never
    scanned; every other name keeps its ndim across the bridge."""
    head, period, groups = cfg.layer_pattern()
    scanned = range(head, head + period * groups)
    out = {}
    for name, p in params.items():
        ndim = len(p.shape)
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) in scanned:
            ndim += 1
        out[name] = ndim >= 2
    return out


def cache_from_jax(np_cache: dict, cfg) -> list[dict[str, torch.Tensor]]:
    """Reference decode cache ({"head", "blocks", "tail"}, numpy leaves,
    contiguous or paged) -> the port's per-layer cache list (CPU tensors,
    the reference's dtypes)."""
    layers = _layers(np_cache["head"], np_cache["blocks"], np_cache["tail"],
                     cfg, "cache")
    return [{k: _tensor(v) for k, v in layer.items()} for layer in layers]


def cross_kv_from_jax(np_kv: dict, cfg) -> dict[int, dict]:
    """Reference context K/V ({"head": {i}, "blocks": {j}, "tail": {t}},
    numpy leaves) -> the port's {layer index: {"k", "v"}} (CPU tensors):
    layer ``head + g * period + j`` reads ``blocks[j][leaf][g]`` and tail
    entry t is layer ``head + period * groups + t``."""
    head, period, groups = cfg.layer_pattern()
    out = dict(np_kv["head"])
    for j, kv in np_kv["blocks"].items():
        for g in range(groups):
            out[head + g * period + j] = _index(kv, g)
    for t, kv in np_kv["tail"].items():
        out[head + period * groups + t] = kv
    return {i: {k: _tensor(v) for k, v in out[i].items()}
            for i in sorted(out)}


def image_params_from_jax(np_params: dict) -> dict[str, torch.Tensor]:
    """Reference ``MuxMLP`` / ``MuxCNN`` param tree (numpy leaves) -> the
    port's state_dict: ``w1``, ``c1``, ``readout``, ``mux.o``, ... keep
    their names, shapes and values."""
    out: dict[str, torch.Tensor] = {}
    _flatten(np_params, "", out)
    return out


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree

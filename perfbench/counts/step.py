"""FLOPs of one step that its result reads, from the configuration's
shapes.

The backbone counts every row that carries work (the index-embed prefix
included) through the projections, the MLP and attention (causal
attention over its pairs, about half); the demux its rows
(``kernels.index_embed_demux``); the task its heads and losses: the LM
logits of the positions the loss reads, the classifier's head at
position 0, the retrieval logits of the instance drawn at each position.
Logits that nothing reads (the vocabulary logits ``Backbone.forward``
computes for the ``cls`` task) are not counted.
"""
from __future__ import annotations

from perfbench.counts import kernels


def backbone(shape: dict, seqs: int, rows: int) -> int:
    """``seqs`` sequences of ``rows`` positions through every layer."""
    d, hd = shape["d_model"], shape["head_dim"]
    h, kv, ff = shape["n_heads"], shape["n_kv_heads"], shape["d_ff"]
    n_rows = seqs * rows
    proj = 2 * n_rows * d * (h + 2 * kv) * hd + 2 * n_rows * h * hd * d
    mlp = (3 if shape["gated_mlp"] else 2) * 2 * n_rows * d * ff
    attn = 4 * seqs * h * kernels.attention_pairs(rows, rows,
                                                  shape["causal"]) * hd
    return shape["n_layers"] * (proj + mlp + attn)


def offline_step(shape: dict) -> int:
    """One offline batch: B groups of N instances of L tokens behind a
    prefix of P rows, task ``lm`` or ``cls``, retrieval when alpha > 0."""
    b, n, l, p = shape["groups"], shape["n"], shape["seq_len"], \
        shape["prefix"]
    d, v = shape["d_model"], shape["vocab"]
    flops = backbone(shape, b, p + l)
    flops += kernels.index_embed_demux(b, n, l, d, shape["demux_hidden"])[0]
    if shape["task"] == "lm":
        flops += 2 * b * n * (l - 1) * d * v
    elif shape["task"] == "cls":
        flops += 2 * b * n * d * shape["n_classes"]
    else:
        raise ValueError(f"no count for task {shape['task']!r}")
    if shape["retrieval_alpha"] > 0:
        flops += 2 * b * l * d * v
    return flops


def serve_step(shape: dict, rows_keys: list, emitted: int) -> int:
    """One serving step: each live slot's rows (positions it advanced)
    through the backbone, attending to the keys mapped before them and to
    its earlier rows; the demux and the logits of the tokens emitted."""
    d, hd = shape["d_model"], shape["head_dim"]
    h, kv, ff = shape["n_heads"], shape["n_kv_heads"], shape["d_ff"]
    n_rows = sum(rows for rows, _ in rows_keys)
    pairs = sum(rows * keys + rows * (rows + 1) // 2
                for rows, keys in rows_keys)
    proj = 2 * n_rows * d * (h + 2 * kv) * hd + 2 * n_rows * h * hd * d
    mlp = (3 if shape["gated_mlp"] else 2) * 2 * n_rows * d * ff
    per_layer = proj + mlp + 4 * h * hd * pairs
    hidden = shape["demux_hidden"]
    demux = emitted * (2 * 2 * d * hidden + 2 * hidden * d)
    return shape["n_layers"] * per_layer + demux + \
        emitted * 2 * d * shape["vocab"]

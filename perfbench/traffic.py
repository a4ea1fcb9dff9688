"""The general traffic generator: a traffic file (``traffic/<name>.json``)
of parameters, and the seed, give the inputs of a run.

``offline``: ``batches`` distinct batches of ``groups`` mux groups x N
instances (N from the configuration) x ``seq_len`` token ids uniform
over the vocabulary; for the ``cls`` task, labels uniform over
``n_classes``; where the configuration has a retrieval loss, the
instance index drawn at each (group, position), uniform over N.

``serve_backlog``: requests whose prompt lengths are uniform over
``prompt_min``..``prompt_max`` and whose output budgets are geometric
with mean ``output_mean``, capped at ``output_max``; a list of
``pool_requests`` such sizes is drawn once from ``sizes_seed`` and every
run serves it in an order drawn from its seed (cycling), so every seed
offers the same work; token ids are uniform over the vocabulary, greedy.

Every seed gives the same sizes; only the values (and an order) differ.
"""
from __future__ import annotations

import math
import random

import torch


def offline_batches(traffic: dict, config: dict, seed: int, device) -> list:
    if traffic["kind"] != "offline":
        raise ValueError(f"traffic kind {traffic['kind']!r} is not offline")
    n, v = config["mux"]["n"], config["model"]["vocab"]
    b, l = traffic["groups"], traffic["seq_len"]
    # A generator of its own, apart from the weights' (seeded the same).
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    out = []
    for _ in range(traffic["batches"]):
        batch = {"tokens": torch.randint(0, v, (b, n, l), generator=gen,
                                         device=device)}
        if traffic["task"] == "cls":
            batch["labels"] = torch.randint(0, traffic["n_classes"], (b, n),
                                            generator=gen, device=device)
        batch["index"] = torch.randint(0, n, (b, l), generator=gen,
                                       device=device)
        out.append(batch)
    return out


def backlog_sizes(traffic: dict) -> list[tuple[int, int]]:
    """The fixed list of (prompt length, output budget)."""
    if traffic["kind"] != "serve_backlog":
        raise ValueError(f"traffic kind {traffic['kind']!r} is not "
                         f"serve_backlog")
    rng = random.Random(traffic["sizes_seed"])
    p = 1.0 / traffic["output_mean"]
    sizes = []
    for _ in range(traffic["pool_requests"]):
        prompt = rng.randint(traffic["prompt_min"], traffic["prompt_max"])
        out = math.ceil(math.log(1.0 - rng.random()) / math.log(1.0 - p))
        sizes.append((prompt, max(1, min(traffic["output_max"], out))))
    return sizes


def backlog(traffic: dict, config: dict, seed: int):
    """Endless (prompt int32 array, output budget) pairs: the fixed sizes
    in an order drawn from ``seed``, token ids from ``seed``."""
    import numpy as np

    sizes = backlog_sizes(traffic)
    order = list(range(len(sizes)))
    random.Random(seed).shuffle(order)
    tokens = np.random.default_rng(seed)
    vocab = config["model"]["vocab"]
    while True:
        for i in order:
            prompt, out = sizes[i]
            yield tokens.integers(0, vocab, prompt, dtype=np.int32), out

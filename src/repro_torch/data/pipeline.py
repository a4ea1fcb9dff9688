"""Batching pipeline — the port's own copy of ``repro.data.pipeline``:
seeded iterators; mux grouping reshapes an effective batch of B*N
instances into (B, N, ...) tuples (the paper's semantics: the instance
count is B*N, the backbone sees B sequences)."""
from __future__ import annotations

import numpy as np


def batches(task, batch_size: int, steps: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield task.sample(batch_size, rng)


def mux_batches(task, groups: int, n_mux: int, steps: int, *, seed: int = 0):
    """Yield batches with a leading (groups, n_mux) layout."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        flat = task.sample(groups * n_mux, rng)
        yield {k: v.reshape(groups, n_mux, *v.shape[1:])
               for k, v in flat.items()}

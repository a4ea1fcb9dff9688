"""Synthetic MNIST-like digits — the port's copy of ``repro.data.images``
(numpy only; offline stand-in for Sec 5 / Fig 7a).

Each class has a fixed random smooth template (20x20, matching the paper's
center crop, A.10); samples are template + Gaussian noise + random shift.
Linear separability is controlled by the noise scale."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticDigits:
    n_classes: int = 10
    size: int = 20
    noise: float = 0.4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = self.size
        raw = rng.normal(size=(self.n_classes, s + 4, s + 4))
        # smooth the templates so shifts are meaningful (MNIST-ish strokes)
        k = np.ones((3, 3)) / 9.0
        sm = raw.copy()
        for _ in range(2):
            p = np.pad(sm, ((0, 0), (1, 1), (1, 1)), mode="edge")
            sm = sum(p[:, i:i + s + 4, j:j + s + 4] * k[i, j]
                     for i in range(3) for j in range(3))
        self.templates = sm / np.abs(sm).max()

    def sample(self, n: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(self.seed + 1)
        s = self.size
        labels = rng.integers(0, self.n_classes, size=(n,), dtype=np.int32)
        dx = rng.integers(0, 5, size=(n,))
        dy = rng.integers(0, 5, size=(n,))
        imgs = np.empty((n, s, s), np.float32)
        for i in range(n):
            t = self.templates[labels[i]]
            imgs[i] = t[dy[i]:dy[i] + s, dx[i]:dx[i] + s]
        imgs += self.noise * rng.normal(size=imgs.shape).astype(np.float32)
        return {"images": imgs, "labels": labels}

"""Activation functions, by the names ``ModelConfig.activation`` uses.

GELU is the tanh approximation, as in the reference (``jax.nn.gelu``
defaults to it); PyTorch's default is the exact erf form."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x):
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    """Squared ReLU — Nemotron-4 FFN activation (arXiv:2402.16819)."""
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
    "squared_relu": squared_relu,
    "tanh": torch.tanh,
}


def get(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; have {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]

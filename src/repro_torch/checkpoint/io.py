"""Checkpoints in the reference's file format (``repro.checkpoint.io``): one
``.npz`` whose entries are the tree's leaves under ``/``-joined key paths
(list indices as numbers), bfloat16 stored as its ``uint16`` bits, and a
``__meta__`` entry holding JSON {"step", "dtypes", caller's meta}; written
to a temporary file in the target's directory and moved over the target
with ``os.replace``, so a failed write leaves neither a partial file nor
the temporary one.

A tree is nested dicts and lists whose leaves are tensors, numpy arrays or
ints; an ``nn.Module`` stands for its ``state_dict`` (so a train state
``{"model", "task_head", "opt_state", "step"}`` saves as it is).  An int
is stored as a 0-d int32 array, as the reference stores its step counters.

``read_reference_checkpoint`` reads a file the reference wrote back into
its nested tree, for ``bridge.params_from_jax`` / ``opt_state_from_jax``.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch
from torch import nn


def _items(tree, prefix: str = ""):
    """(key path, leaf) in order; an ``nn.Module`` is its state_dict."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (int, np.integer)):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype))


def save_checkpoint(path: str, tree, *, step: int = 0,
                    meta: dict | None = None) -> None:
    arrays, dtypes = {}, {}
    for key, leaf in _items(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"step": step, "dtypes": dtypes,
                    **(meta or {})}).encode(), dtype=np.uint8)
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, tree_like):
    """Restore into the structure of ``tree_like``: (tree, meta).  Tensors
    and modules are loaded in place (``copy_``, ``load_state_dict``:
    device and dtype kept, shapes must match) and returned as the same
    objects; an int leaf comes back as the stored int, a numpy leaf as the
    stored array."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        dtypes = meta["dtypes"]

        def stored(key):
            if key not in dtypes:
                raise KeyError(f"{path} has no entry {key!r}")
            return _from_numpy(data[key], dtypes[key])

        def restore(node, prefix: str):
            if isinstance(node, nn.Module):
                node.load_state_dict(
                    {k: stored(f"{prefix}{k}")
                     for k in node.state_dict()}, strict=True)
                return node
            if isinstance(node, dict):
                return {k: restore(v, f"{prefix}{k}/")
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(restore(v, f"{prefix}{i}/")
                                  for i, v in enumerate(node))
            t = stored(prefix[:-1])
            if torch.is_tensor(node):
                if tuple(t.shape) != tuple(node.shape):
                    raise ValueError(f"{prefix[:-1]}: stored shape "
                                     f"{tuple(t.shape)}, expected "
                                     f"{tuple(node.shape)}")
                with torch.no_grad():
                    node.copy_(t)
                return node
            if isinstance(node, (int, np.integer)):
                return int(t)
            return t.numpy()

        return restore(tree_like, ""), meta


def read_reference_checkpoint(path: str):
    """(tree, meta) of a checkpoint the reference wrote (``python -m
    repro.launch.train --ckpt``, or its ``save_checkpoint``): nested dicts,
    with the key paths' list indices rebuilt as lists (``blocks/0/...``),
    every leaf a CPU tensor of the stored dtype (numpy has no bfloat16).
    Read with numpy alone: no JAX."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        root: dict = {}
        for key, dtype in meta["dtypes"].items():
            node = root
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = _from_numpy(data[key], dtype)
    return _lists(root), meta


def _lists(node):
    """Dicts whose keys are exactly 0..n-1 become lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node

"""Retrieval warm-up objective (paper Sec 3.3, Eq. 3) — the port of
``repro.core.retrieval``.

From the demultiplexed hidden states, retrieve the token identity of a
randomly chosen instance index I ~ U[0, N) at every position:

    L_retr(x^{1:N}) = sum_j -log P(w_j^I | h_j^I)

One random instance per position is scored (retrieving every (i, j) pair
is too expensive, as the paper notes); the evaluation metric scores all.
The draw comes from a ``torch.Generator``; JAX's ``randint`` bits cannot be
reproduced in torch, so ``retrieval_loss`` also takes the (B, L) index
itself.
"""
from __future__ import annotations

import torch


def retrieval_logits(demuxed, embed_table):
    """demuxed: (B, N, L, d); tied-embedding retrieval head -> (B, N, L, V)."""
    return demuxed @ embed_table.to(demuxed.dtype).T


def retrieval_index(generator, b: int, n: int, l: int, *, device=None):
    """I ~ U[0, N) per (b, j): a (B, L) int64 tensor drawn from
    ``generator`` (on the generator's device unless ``device`` is given)."""
    device = device if device is not None else generator.device
    return torch.randint(0, n, (b, l), generator=generator, device=device)


def retrieval_loss(generator, demuxed, tokens, embed_table, *,
                   valid_mask=None, index=None):
    """Paper Eq. 3: one instance I per (b, j), cross-entropy on it only.

    demuxed: (B, N, L, d); tokens: (B, N, L) int original inputs;
    ``index``: the (B, L) draw of I, or None to draw it from
    ``generator``.  Returns the scalar float32 mean NLL."""
    b, n, l, d = demuxed.shape
    if index is None:
        index = retrieval_index(generator, b, n, l, device=demuxed.device)
    index = index.to(device=demuxed.device, dtype=torch.int64)
    sel_h = torch.gather(demuxed, 1,
                         index[:, None, :, None].expand(b, 1, l, d))[:, 0]
    sel_t = torch.gather(tokens.long(), 1, index[:, None, :])[:, 0]
    logits = sel_h @ embed_table.to(sel_h.dtype).T
    logp = torch.log_softmax(logits, dim=-1, dtype=torch.float32)
    nll = -torch.gather(logp, -1, sel_t[..., None])[..., 0]
    if valid_mask is not None:
        m = torch.gather(valid_mask, 1, index[:, None, :])[:, 0].float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def retrieval_accuracy(demuxed, tokens, embed_table):
    """Exact-match retrieval accuracy over ALL (instance, position) pairs —
    the paper's Fig. 4b evaluation metric."""
    pred = torch.argmax(retrieval_logits(demuxed, embed_table), dim=-1)
    return torch.mean((pred == tokens).float())

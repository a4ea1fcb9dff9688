"""Loss functions — the port of ``repro.training.losses``: task losses (LM /
classification / tagging) of the paper's mixed objective
L = (1 - alpha) L_task + alpha L_retrieval (Eq. 4), all in float32."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, mask=None):
    """logits (..., C) of any float dtype; labels (...) int.  Mean NLL over
    ``mask`` (its sum clamped at 1)."""
    logp = torch.log_softmax(logits, dim=-1, dtype=torch.float32)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return torch.mean(nll)
    m = mask.float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def accuracy(logits, labels, mask=None):
    ok = (torch.argmax(logits, dim=-1) == labels).float()
    if mask is None:
        return torch.mean(ok)
    m = mask.float()
    return torch.sum(ok * m) / torch.clamp(torch.sum(m), min=1.0)


def lm_loss(logits, tokens):
    """Next-token loss.  Works for (B, L, V) and muxed (B, N, L, V) — each
    stream predicts its own next token from the demuxed states."""
    return cross_entropy(logits[..., :-1, :], tokens[..., 1:]), \
        accuracy(logits[..., :-1, :], tokens[..., 1:])


def cls_loss(demuxed, head_w, labels):
    """Sequence classification from the [CLS] (position-0) demuxed state.
    demuxed (B, [N,] L, d); head_w (d, n_classes); labels (B[, N])."""
    logits = demuxed[..., 0, :].float() @ head_w.float()
    return cross_entropy(logits, labels), accuracy(logits, labels)


def tag_loss(demuxed, head_w, labels):
    """Token-level classification (NER proxy).  labels (B, [N,] L)."""
    logits = demuxed.float() @ head_w.float()
    return cross_entropy(logits, labels), accuracy(logits, labels)

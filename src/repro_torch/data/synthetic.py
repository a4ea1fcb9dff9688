"""Synthetic task generators — the port's own copy of the reference's
numpy-only ``repro.data.synthetic`` (GLUE/Wikitext replaced by
controllable-difficulty proxies).  The same seed gives the same arrays.

  * RetrievalTask             — random token streams for the warm-up (Sec 3.3)
  * KeywordClassificationTask — SST-2 proxy: exactly one signature token is
                                planted per sequence; the label is its class.
                                Needs position-invariant aggregation.
  * PairMatchTask             — MNLI/QQP proxy: the label depends on whether
                                the classes of TWO planted tokens match
                                (entail / contradict / neutral analogue).
  * TaggingTask               — CoNLL NER proxy: per-token labels from an
                                entity lexicon (type or O).

All generators are seeded and emit numpy int32; vocab layout reserves
[0, n_signal) for signal tokens and the rest for filler.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RetrievalTask:
    vocab: int = 512
    seq_len: int = 32
    seed: int = 0

    def sample(self, n: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(self.seed)
        tokens = rng.integers(1, self.vocab, size=(n, self.seq_len),
                              dtype=np.int32)
        return {"tokens": tokens}


@dataclasses.dataclass
class KeywordClassificationTask:
    vocab: int = 512
    seq_len: int = 32
    n_classes: int = 4
    seed: int = 0

    def sample(self, n: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(self.seed)
        c = self.n_classes
        filler = rng.integers(c + 1, self.vocab, size=(n, self.seq_len),
                              dtype=np.int32)
        labels = rng.integers(0, c, size=(n,), dtype=np.int32)
        pos = rng.integers(1, self.seq_len, size=(n,))
        filler[np.arange(n), pos] = labels + 1  # signature tokens are 1..c
        filler[:, 0] = 0                        # [CLS]
        return {"tokens": filler, "labels": labels}


@dataclasses.dataclass
class PairMatchTask:
    """Two signal tokens are planted; label = f(class_a, class_b):
    0 if equal ("entailment"), 1 if (a+1) % k == b ("contradiction"),
    else 2 ("neutral")."""
    vocab: int = 512
    seq_len: int = 32
    n_signal: int = 6
    seed: int = 0

    @property
    def n_classes(self) -> int:
        return 3

    def sample(self, n: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(self.seed)
        k = self.n_signal
        toks = rng.integers(k + 1, self.vocab, size=(n, self.seq_len),
                            dtype=np.int32)
        a = rng.integers(0, k, size=(n,))
        b = rng.integers(0, k, size=(n,))
        half = self.seq_len // 2
        pa = rng.integers(1, half, size=(n,))
        pb = rng.integers(half, self.seq_len, size=(n,))
        toks[np.arange(n), pa] = a + 1
        toks[np.arange(n), pb] = b + 1
        toks[:, 0] = 0  # [CLS]
        labels = np.where(a == b, 0,
                          np.where((a + 1) % k == b, 1, 2)).astype(np.int32)
        return {"tokens": toks, "labels": labels}


@dataclasses.dataclass
class TaggingTask:
    """Per-token classification: tokens < n_entity_types*lex are entities of
    type tok // lex; everything else is O (class 0)."""
    vocab: int = 512
    seq_len: int = 32
    n_entity_types: int = 3
    lexicon_per_type: int = 8
    entity_rate: float = 0.2
    seed: int = 0

    @property
    def n_classes(self) -> int:
        return self.n_entity_types + 1

    def sample(self, n: int, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng(self.seed)
        ent_span = self.n_entity_types * self.lexicon_per_type
        toks = rng.integers(ent_span, self.vocab, size=(n, self.seq_len),
                            dtype=np.int32)
        is_ent = rng.random((n, self.seq_len)) < self.entity_rate
        ent_tok = rng.integers(0, ent_span, size=(n, self.seq_len),
                               dtype=np.int32)
        toks = np.where(is_ent, ent_tok, toks)
        labels = np.where(toks < ent_span, toks // self.lexicon_per_type + 1,
                          0).astype(np.int32)
        return {"tokens": toks, "labels": labels}

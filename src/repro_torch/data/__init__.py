"""Seeded numpy task generators and batch iterators (copies of the
reference's numpy-only ``repro.data`` modules; the image digits wait for
the image models)."""
from repro_torch.data.pipeline import batches, mux_batches
from repro_torch.data.synthetic import (
    KeywordClassificationTask,
    PairMatchTask,
    RetrievalTask,
    TaggingTask,
)

__all__ = [
    "RetrievalTask",
    "KeywordClassificationTask",
    "PairMatchTask",
    "TaggingTask",
    "batches",
    "mux_batches",
]

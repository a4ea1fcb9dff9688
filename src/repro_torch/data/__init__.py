"""Seeded numpy task generators and batch iterators (copies of the
reference's numpy-only ``repro.data`` modules)."""
from repro_torch.data.images import SyntheticDigits
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
    "SyntheticDigits",
    "batches",
    "mux_batches",
]

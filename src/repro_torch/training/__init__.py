"""Training stack: the paper's mixed objective, the train step (AdamW,
clipping, microbatching), ``fit`` and ``make_eval_step``."""

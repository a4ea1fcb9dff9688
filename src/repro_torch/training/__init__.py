"""Evaluation half of the training stack: the paper's mixed objective and
``Trainer.make_eval_step`` (the optimizer and the train step wait for the
training slice)."""

"""Evaluation half of ``repro.training.trainer``: ``TrainConfig``, the task
head of ``init_state``, the paper's mixed objective (``loss_fn``) and
``make_eval_step``.

The reference's state is a pytree {params, opt_state, step}; here it is a
dict {"model": Backbone, "task_head": {"w": (d, n_classes)}} — the task
head only for the cls/tag tasks.  ``make_optimizer``, ``make_train_step``
and ``fit`` wait for the training slice (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import retrieval as retr
from repro_torch.models import Backbone
from repro_torch.training import losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields and defaults."""
    task: str = "lm"            # lm | cls | tag | retrieval
    n_classes: int = 0          # cls/tag head width
    lr: float = 5e-5            # paper A.9 default for multiplexed models
    warmup: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    weight_decay: float = 0.01
    moe_aux_coef: float = 0.01
    state_dtype: Optional[str] = None
    microbatch: int = 0


class Trainer:
    @staticmethod
    def init_state(cfg: ModelConfig, tcfg: TrainConfig, *, seed: int = 0,
                   device=None, use_flash: bool = False) -> dict:
        """The backbone from ``seed``; for cls/tag a task head ``w`` of
        shape (d, n_classes), 0.02 * N(0, 1) drawn in float32 from a
        generator seeded with ``seed + 1`` and cast to the param dtype."""
        model = Backbone(cfg, seed=seed, device=device, use_flash=use_flash)
        state = {"model": model}
        if tcfg.task in ("cls", "tag"):
            if tcfg.n_classes <= 0:
                raise ValueError("cls/tag task needs n_classes")
            g = torch.Generator(device=model.device).manual_seed(seed + 1)
            w = 0.02 * torch.randn((cfg.d_model, tcfg.n_classes),
                                   generator=g, device=model.device)
            state["task_head"] = {"w": w.to(cfg.pdtype)}
        return state

    @staticmethod
    def load_params(state: dict, params: dict[str, torch.Tensor]) -> None:
        """Load a ``bridge.params_from_jax`` dict: ``task_head.w`` into the
        state's task head, every other entry into the model (strict)."""
        params = dict(params)
        w = params.pop("task_head.w", None)
        if (w is None) != ("task_head" not in state):
            raise ValueError("the params and the state disagree on having "
                             "a task head")
        state["model"].load_state_dict(params, strict=True)
        if w is not None:
            head = state["task_head"]["w"]
            if tuple(w.shape) != tuple(head.shape):
                raise ValueError(f"task_head.w is {tuple(w.shape)}, the "
                                 f"state's is {tuple(head.shape)}")
            with torch.no_grad():
                head.copy_(w)

    # -- loss ------------------------------------------------------------------

    @staticmethod
    def loss_fn(state: dict, batch: dict, rng, cfg: ModelConfig,
                tcfg: TrainConfig, *, retr_index=None):
        """(total, metrics) of the paper's mixed objective, as the
        reference computes it.  ``rng`` is the ``torch.Generator`` the
        retrieval auxiliary draws its instance index from, unless
        ``retr_index`` (B, L) gives that index."""
        model = state["model"]
        tokens = batch["tokens"]
        out = model(tokens)
        mux = cfg.mux

        if tcfg.task == "lm":
            task_loss, acc = losses.lm_loss(out["logits"], tokens)
        elif tcfg.task == "cls":
            task_loss, acc = losses.cls_loss(
                out["demuxed"], state["task_head"]["w"], batch["labels"])
        elif tcfg.task == "tag":
            task_loss, acc = losses.tag_loss(
                out["demuxed"], state["task_head"]["w"], batch["labels"])
        elif tcfg.task == "retrieval":
            task_loss = torch.zeros((), dtype=torch.float32,
                                    device=model.device)
            acc = torch.zeros((), dtype=torch.float32, device=model.device)
        else:
            raise ValueError(tcfg.task)

        # Retrieval auxiliary objective (paper Eq. 3/4): only meaningful for
        # muxed models; the demuxed states must reconstruct the inputs.
        alpha = mux.retrieval_alpha if (mux.active or
                                        tcfg.task == "retrieval") else 0.0
        if tcfg.task == "retrieval":
            alpha = 1.0
        if alpha > 0.0 and mux.active:
            retr_loss = retr.retrieval_loss(
                rng, out["demuxed"], tokens, model.embed.table,
                index=retr_index)
        else:
            retr_loss = torch.zeros((), dtype=torch.float32,
                                    device=model.device)

        total = (1.0 - alpha) * task_loss + alpha * retr_loss \
            + tcfg.moe_aux_coef * out["aux"]
        metrics = dict(task_loss=task_loss, retr_loss=retr_loss,
                       moe_aux=out["aux"], acc=acc)
        return total, metrics

    # -- step factories -----------------------------------------------------------

    @staticmethod
    def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
        """``eval_step(state, batch, rng, *, retr_index=None) -> metrics``
        (task_loss, retr_loss, moe_aux, acc, loss: 0-d float32 tensors),
        run under ``torch.inference_mode``.  The batch's arrays (numpy or
        tensors) go to the model's device, integers as int64."""
        def eval_step(state, batch, rng, *, retr_index=None):
            device = state["model"].device
            batch = {k: _to_device(v, device) for k, v in batch.items()}
            with torch.inference_mode():
                loss, metrics = Trainer.loss_fn(state, batch, rng, cfg, tcfg,
                                                retr_index=retr_index)
            metrics["loss"] = loss
            return metrics

        return eval_step


def _to_device(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)

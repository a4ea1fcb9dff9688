"""Training stack — the port of ``repro.training.trainer``: ``TrainConfig``,
``init_state`` with the task head, the paper's mixed objective
(``loss_fn``), ``make_optimizer``, ``make_train_step`` (with gradient
accumulation over microbatches), ``make_eval_step`` and ``fit``.

The reference's state is a pytree {params, opt_state, step}; here it is a
dict {"model": Backbone, "task_head": {"w": (d, n_classes)}} (the task
head only for the cls/tag tasks), to which the first train step adds
"opt_state" (AdamW's {"mu", "nu", "step"}, keyed by ``Trainer.params``'
names) and "step".  The train step runs autograd over the plain path and
updates the parameters in place.  Like the reference, which cannot
differentiate its Pallas kernels, it does not train through the CUDA
kernels (none has a backward), and refuses a config or model that would
send the forward through them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import decay_mask
from repro_torch.configs.base import ModelConfig
from repro_torch.core import retrieval as retr
from repro_torch.models import Backbone
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.optim.schedule import linear_warmup_cosine
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
    def make_optimizer(tcfg: TrainConfig) -> AdamW:
        return AdamW(lr=linear_warmup_cosine(tcfg.lr, tcfg.warmup,
                                             tcfg.total_steps),
                     weight_decay=tcfg.weight_decay,
                     state_dtype=tcfg.state_dtype)

    @staticmethod
    def params(state: dict) -> dict[str, torch.Tensor]:
        """The trained tensors by name: the model's parameters (its
        ``state_dict`` names) and, for cls/tag, ``task_head.w`` — the names
        ``bridge.params_from_jax`` gives."""
        out = dict(state["model"].named_parameters())
        if "task_head" in state:
            out["task_head.w"] = state["task_head"]["w"]
        return out

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
        ``retr_index`` (B, L) gives that index.  A ``context`` in the batch
        (B, Lc, context_dim) goes to the model's cross layers."""
        model = state["model"]
        tokens = batch["tokens"]
        out = model(tokens, context=batch.get("context"))
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
    def grads(state: dict, batch: dict, rng, cfg: ModelConfig,
              tcfg: TrainConfig, *, retr_index=None):
        """(loss, metrics, grads) of ``loss_fn`` by autograd over the plain
        path, grads keyed by ``Trainer.params``' names (zeros for a tensor
        the loss does not reach, e.g. a frozen mux transform, as the
        reference's stop_gradient gives).  With ``tcfg.microbatch`` = k > 1
        the batch's leading axis is split into k chunks (it must divide),
        and loss, metrics and grads are summed over the chunks and divided
        by k, as the reference's scan does; ``retr_index`` is then a list
        of one (B/k, L) index per chunk (the reference draws chunk i's
        from the i-th key of ``jax.random.split(rng, k)``)."""
        k = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1
        params = Trainer.params(state)
        if "task_head" in state:
            state["task_head"]["w"].requires_grad_(True)
        for p in params.values():
            p.grad = None
        if k > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % k:
                raise ValueError(f"microbatch={k} does not divide the "
                                 f"batch's {rows} rows")
            chunks = [{key: v.chunk(k)[i] for key, v in batch.items()}
                      for i in range(k)]
            index = [None] * k if retr_index is None else list(retr_index)
            if len(index) != k:
                raise ValueError(f"retr_index needs one index per "
                                 f"microbatch ({k}), got {len(index)}")
        else:
            chunks, index = [batch], [retr_index]
        loss_sum, metric_sum = 0.0, {}
        with torch.enable_grad():
            for chunk, ix in zip(chunks, index):
                loss, metrics = Trainer.loss_fn(state, chunk, rng, cfg, tcfg,
                                                retr_index=ix)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
                for key, v in metrics.items():
                    metric_sum[key] = metric_sum.get(key, 0.0) + v.detach()
        def mean(total):
            return total / k if k > 1 else total

        grads = {}
        for name, p in params.items():
            grads[name] = torch.zeros_like(p) if p.grad is None \
                else mean(p.grad)
            p.grad = None
        return mean(loss_sum), {key: mean(v)
                                for key, v in metric_sum.items()}, grads

    @staticmethod
    def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
        """``train_step(state, batch, rng, *, retr_index=None) -> (state,
        metrics)``: ``Trainer.grads``, clipped by global norm, then one
        AdamW step with the reference's weight-decay mask
        (``bridge.decay_mask``), applied in place to
        ``Trainer.params(state)``; the first step adds "opt_state" and
        "step" to the state.  Metrics (0-d float32 tensors on the model's
        device): loss, grad_norm, task_loss, retr_loss, moe_aux, acc."""
        if cfg.mux.use_kernel:
            raise ValueError(
                "make_train_step: mux.use_kernel sends the forward through "
                "the CUDA mux and demux kernels, which have no backward (nor "
                "do the reference's Pallas kernels); train on the plain path "
                "and evaluate the trained weights through "
                "Backbone.with_config")
        opt = Trainer.make_optimizer(tcfg)

        def train_step(state, batch, rng, *, retr_index=None):
            model = state["model"]
            if model.use_flash:
                raise ValueError(
                    "train_step: the model routes attention through the "
                    "flash kernel (use_flash), which has no backward; "
                    "train a model built without it")
            batch = {key: _to_device(v, model.device)
                     for key, v in batch.items()}
            loss, metrics, grads = Trainer.grads(state, batch, rng, cfg, tcfg,
                                                 retr_index=retr_index)
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
            params = Trainer.params(state)
            if "opt_state" not in state:
                state["opt_state"] = opt.init(params)
                state["step"] = 0
            opt.step_(grads, state["opt_state"], params,
                      decay_mask(cfg, params))
            state["step"] += 1
            metrics.update(loss=loss, grad_norm=gnorm)
            return state, metrics

        return train_step

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

    # -- convenience loop (CPU-scale experiments / examples) -------------------

    @staticmethod
    def fit(cfg: ModelConfig, tcfg: TrainConfig, batch_iter, *,
            seed: int = 0, state: Optional[dict] = None, log_every: int = 50,
            callback=None, device=None):
        """Train over ``batch_iter``; returns (state, history).  A new state
        is ``init_state(cfg, tcfg, seed=seed, device=device)``; the
        retrieval index is drawn from a generator seeded with ``seed + 2``
        on the model's device.  ``history`` holds {"step", metrics as
        floats} every ``log_every`` steps and at ``total_steps - 1``, and
        ``callback(step, metrics)`` sees each entry."""
        state = state or Trainer.init_state(cfg, tcfg, seed=seed,
                                            device=device)
        rng = torch.Generator(device=state["model"].device) \
            .manual_seed(seed + 2)
        step_fn = Trainer.make_train_step(cfg, tcfg)
        history = []
        for i, batch in enumerate(batch_iter):
            state, metrics = step_fn(state, batch, rng)
            if i % log_every == 0 or i == tcfg.total_steps - 1:
                m = {key: float(v) for key, v in metrics.items()}
                history.append({"step": i, **m})
                if callback:
                    callback(i, m)
        return state, history


def _to_device(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)

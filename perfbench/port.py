"""The program under test, built from a configuration file: the port's
``ModelConfig`` and its evaluation state over the benchmark's weights.
This module and the drivers are the harness's only importers of
``repro_torch``; the reference never is one."""
from __future__ import annotations

import dataclasses

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "norm", "activation", "gated_mlp",
              "qkv_bias", "rope_theta", "tie_embeddings", "causal")


def model_config(spec: dict):
    """The registry's ``spec["arch"]`` with the file's model, mux and
    dtype.  A model key that differs from the registry's and is not in
    ``spec["reduced"]`` raises: the file holds the configuration as it is
    run."""
    from repro_torch.configs.registry import get_config

    base = get_config(spec["arch"])
    model = spec["model"]
    unknown = set(model) - set(MODEL_KEYS)
    if unknown:
        raise ValueError(f"{spec['name']}: unknown model keys "
                         f"{sorted(unknown)}")
    changed = [k for k in model if model[k] != getattr(base, k)]
    unlisted = sorted(set(changed) - set(spec.get("reduced", [])))
    if unlisted:
        raise ValueError(f"{spec['name']}: {unlisted} differ from "
                         f"{spec['arch']} and are not in 'reduced'")
    mux = dataclasses.replace(base.mux, **spec["mux"])
    return dataclasses.replace(base, **model, mux=mux, dtype=spec["dtype"],
                               param_dtype=spec["dtype"])


def torch_dtype(spec: dict):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        spec["dtype"]]


def eval_state(cfg, task: dict, weights: dict, *, use_flash: bool):
    """(state, eval_step): ``Trainer.init_state`` on ``meta``, every weight
    then assigned from ``weights`` by name (strict), and
    ``Trainer.make_eval_step``."""
    from repro_torch.training.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(task=task["task"], n_classes=task.get("n_classes", 0))
    state = Trainer.init_state(cfg, tcfg, device="meta", use_flash=use_flash)
    model_w = {k: v for k, v in weights.items() if k != "task_head.w"}
    state["model"].load_state_dict(model_w, strict=True, assign=True)
    if "task_head" in state:
        state["task_head"]["w"] = weights["task_head.w"]
    state["model"].eval()
    return state, Trainer.make_eval_step(cfg, tcfg)


def launches():
    """The program's counter of kernel launches."""
    from repro_torch.kernels import _build
    return _build.LAUNCHES


def serve_scheduler(cfg, weights: dict, serving: dict):
    """A ``ContinuousScheduler`` over an ``Engine`` of ``serving["slots"]``
    slots and ``serving["max_len"]`` positions, the model's weights
    assigned from ``weights`` by name (strict), the config's serving
    settings from ``serving``'s other keys."""
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import ContinuousScheduler

    knobs = {k: v for k, v in serving.items()
             if k not in ("slots", "max_len")}
    cfg = dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, **knobs))
    model = Backbone(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    model.eval()
    engine = Engine(model, batch=serving["slots"],
                    max_len=serving["max_len"])
    return ContinuousScheduler(engine)


def request(rid: int, prompt, max_new: int):
    """A greedy request with no EOS: it serves its whole budget."""
    from repro_torch.serving.scheduler import Request
    return Request(rid=rid, prompt=prompt, max_new_tokens=max_new)

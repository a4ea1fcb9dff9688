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

On a mesh (``make_train_step(mesh=, mesh_info=)``) the state is held as
``sharding.state_specs`` places it (``sharding.placement.place_state``):
"params" and the AdamW moments become DTensors, each rank holding its
shard, and the model keeps the full parameters as the copy the forward
runs on.  A step cuts the batch into its microbatches, as the reference
does, splits each microbatch's rows over the axes ``MeshInfo.bl_entries``
gives it, runs ``Trainer.grads`` on this rank's rows, averages loss,
metrics and gradients over the mesh's batch axes, clips by the global
norm (the same on every rank), applies AdamW to each rank's shard of the
parameters and moments, and gathers the parameters back into the model:
the numbers of one process, up to the order of the sums.  Tensor-parallel
matmuls and a per-layer gather are not ported (ROADMAP).  An MoE layer
runs the reference's expert-parallel block (``nn.moe``): per-shard
capacity and aux, the tokens all-to-all over the data axis.  Its router
and expert gradients come back as each rank's shard, which a sum over the
model axis completes (``nn.moe.complete_grads``).
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
from repro_torch.nn.moe import (SINGLE, MeshInfo, OnMesh, check_model_mesh,
                                complete_grads)
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
            g = None if model.device.type == "meta" else \
                torch.Generator(device=model.device).manual_seed(seed + 1)
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
                tcfg: TrainConfig, *, retr_index=None,
                on_mesh: Optional[OnMesh] = None):
        """(total, metrics) of the paper's mixed objective, as the
        reference computes it.  ``rng`` is the ``torch.Generator`` the
        retrieval auxiliary draws its instance index from, unless
        ``retr_index`` (B, L) gives that index.  A ``context`` in the batch
        (B, Lc, context_dim) goes to the model's cross layers.
        ``on_mesh`` goes to the model (``Backbone.forward``)."""
        model = state["model"]
        tokens = batch["tokens"]
        out = model(tokens, context=batch.get("context"), on_mesh=on_mesh)
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
              tcfg: TrainConfig, *, retr_index=None,
              on_mesh: Optional[OnMesh] = None):
        """(loss, metrics, grads) of ``loss_fn`` by autograd over the plain
        path, grads keyed by ``Trainer.params``' names (zeros for a tensor
        the loss does not reach, e.g. a frozen mux transform, as the
        reference's stop_gradient gives).  With ``tcfg.microbatch`` = k > 1
        the batch's leading axis is split into k chunks (it must divide),
        and loss, metrics and grads are summed over the chunks and divided
        by k, as the reference's scan does; ``retr_index`` is then a list
        of one (B/k, L) index per chunk (the reference draws chunk i's
        from the i-th key of ``jax.random.split(rng, k)``).  ``on_mesh``:
        as ``loss_fn``."""
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
                                                retr_index=ix,
                                                on_mesh=on_mesh)
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
    def mesh_grads(state: dict, batch: dict, rng, cfg: ModelConfig,
                   tcfg: TrainConfig, *, mesh, mesh_info: MeshInfo,
                   retr_index=None):
        """``Trainer.grads`` of the whole batch on ``mesh``, in the
        reference's order: the batch cut into its k microbatches
        (``tcfg``'s, b / k rows each), this rank's rows of each
        (``placement.batch_rows`` of a microbatch) through
        ``Trainer.grads``, then loss, metrics and grads averaged over the
        mesh's batch axes, so every rank holds the whole batch's, and the
        MoE layers' gradients completed over the model axis
        (``nn.moe.complete_grads``).  A batch axis that a microbatch gives
        to the sequence, or does not split, leaves the rank all of its
        rows; an MoE layer takes its shard of them inside the block.  The
        retrieval index is the whole batch's: ``retr_index`` as
        ``Trainer.grads`` takes it, or drawn from ``rng`` as one process
        draws it (k (b / k, L) draws), this rank taking its rows."""
        from repro_torch.sharding import placement
        model = state["model"]
        _refuse_flash(model)
        batch = {key: _to_device(v, model.device)
                 for key, v in batch.items()}
        b, l = batch["tokens"].shape[0], batch["tokens"].shape[-1]
        k = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1
        if b % k:
            raise ValueError(f"microbatch={k} does not divide the batch's "
                             f"{b} rows")
        rows, axes = placement.batch_rows(mesh, mesh_info, b // k, l)
        # this rank's rows of each microbatch, the microbatches in order
        mine = torch.cat([torch.arange(rows.start, rows.stop) + i * (b // k)
                          for i in range(k)]).to(model.device)
        mux = cfg.mux
        index = None
        if retr_index is not None:
            index = torch.cat(list(retr_index)) if k > 1 else retr_index
        elif mux.active and (tcfg.task == "retrieval"
                             or mux.retrieval_alpha > 0.0):
            index = torch.cat([retr.retrieval_index(rng, b // k, mux.n, l,
                                                    device=model.device)
                               for _ in range(k)])
        if index is not None:
            index = index[mine]
            index = list(index.chunk(k)) if k > 1 else index
        loss, metrics, grads = Trainer.grads(
            state, {key: v[mine] for key, v in batch.items()}, rng, cfg,
            tcfg, retr_index=index, on_mesh=OnMesh(mesh, mesh_info, axes))
        names = list(metrics)
        flat = placement.mean_over(
            [loss, *metrics.values(), *grads.values()], mesh,
            _split_axes(mesh, (mesh_info.pod_axis, mesh_info.data_axis)))
        grads = complete_grads(model, dict(zip(grads, flat[1 + len(names):])),
                               mesh, mesh_info)
        return flat[0], dict(zip(names, flat[1:1 + len(names)])), grads

    @staticmethod
    def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mesh=None,
                        mesh_info: MeshInfo = SINGLE) -> Callable:
        """``train_step(state, batch, rng, *, retr_index=None) -> (state,
        metrics)``: ``Trainer.grads``, clipped by global norm, then one
        AdamW step with the reference's weight-decay mask
        (``bridge.decay_mask``), applied in place to
        ``Trainer.params(state)``; the first step adds "opt_state" and
        "step" to the state.  Metrics (0-d float32 tensors on the model's
        device): loss, grad_norm, task_loss, retr_loss, moe_aux, acc.

        With ``mesh`` (a ``DeviceMesh``; ``mesh_info`` its ``MeshInfo``)
        the first step also places the state on it, and each step runs
        as the module docstring says; ``retr_index`` is the whole batch's.
        A config whose experts the mesh cannot split evenly raises
        (``nn.moe.check_mesh``)."""
        if cfg.mux.use_kernel:
            raise ValueError(
                "make_train_step: mux.use_kernel sends the forward through "
                "the CUDA mux and demux kernels, which have no backward (nor "
                "do the reference's Pallas kernels); train on the plain path "
                "and evaluate the trained weights through "
                "Backbone.with_config")
        opt = Trainer.make_optimizer(tcfg)
        if mesh is not None:
            return _mesh_train_step(cfg, tcfg, opt, mesh, mesh_info)

        def train_step(state, batch, rng, *, retr_index=None):
            model = state["model"]
            _refuse_flash(model)
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


def _refuse_flash(model) -> None:
    if model.use_flash:
        raise ValueError(
            "train_step: the model routes attention through the flash "
            "kernel (use_flash), which has no backward; train a model built "
            "without it")


def _mesh_train_step(cfg: ModelConfig, tcfg: TrainConfig, opt, mesh,
                     mi: MeshInfo) -> Callable:
    """The train step on ``mesh`` (``Trainer.make_train_step``)."""
    from repro_torch.sharding import placement, state_specs
    check_model_mesh(cfg, mi)

    def train_step(state, batch, rng, *, retr_index=None):
        if "params" not in state:
            if "opt_state" not in state:
                state["opt_state"] = opt.init(Trainer.params(state))
                state["step"] = 0
            placement.place_state(state, mesh, state_specs(state, mi))
        loss, metrics, grads = Trainer.mesh_grads(
            state, batch, rng, cfg, tcfg, mesh=mesh, mesh_info=mi,
            retr_index=retr_index)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        _adamw_on_shards(opt, grads, state, decay_mask(cfg, grads), mesh)
        state["step"] += 1
        metrics.update(loss=loss, grad_norm=gnorm)
        return state, metrics

    return train_step


@torch.no_grad()
def _adamw_on_shards(opt, grads: dict, state: dict, decay: dict,
                     mesh) -> None:
    """One AdamW step on each rank's shard: every parameter is brought to
    its moments' placement (a ZeRO-1 moment may be split further), updated
    there with this rank's slice of the (whole, identical on every rank)
    gradient, placed back at its own spec and gathered into the model.  A
    parameter placed as its moments is updated in its own storage."""
    from repro_torch.sharding.placement import local_slice
    opt_state = state["opt_state"]
    shard = {"mu": {}, "nu": {}, "step": opt_state["step"]}
    params, local_grads, moment_placed = {}, {}, {}
    for name, p in state["params"].items():
        pls = opt_state["mu"][name].placements
        if p.placements != pls:
            moment_placed[name] = p.redistribute(mesh, pls)
        params[name] = moment_placed.get(name, p).to_local()
        local_grads[name] = local_slice(grads[name], mesh, pls)
        for m in ("mu", "nu"):
            shard[m][name] = opt_state[m][name].to_local()
    opt.step_(local_grads, shard, params, decay)
    opt_state["step"] = shard["step"]
    compute = Trainer.params(state)
    for name, p in state["params"].items():
        if name in moment_placed:
            p = state["params"][name] = moment_placed[name].redistribute(
                mesh, p.placements)
        whole = all(pl.is_replicate() for pl in p.placements)
        compute[name].copy_(p.to_local() if whole else p.full_tensor())


def _split_axes(mesh, axes) -> tuple:
    """Those of ``axes`` the mesh has and splits (size > 1)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in axes
                 if a in names and mesh.size(names.index(a)) > 1)


def _to_device(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)

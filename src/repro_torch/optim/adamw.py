"""AdamW on dicts of tensors — the port of ``repro.optim.adamw``.

Not ``torch.optim.AdamW``: the reference upcasts each moment to float32,
updates it there and casts it back to the moment dtype (the param dtype,
or ``state_dtype``), takes the bias corrections at ``step + 1`` in
float32, and decays a tensor by ``weight_decay * p`` inside the update
(``-lr * (m_hat / (sqrt(n_hat) + eps) + wd * p)``).  Which tensors it
decays is the caller's ``decay`` mask (``bridge.decay_mask`` gives the
reference's decision for a ``Backbone``'s names)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[int], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_dtype: Optional[str] = None  # None -> follow param dtype

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        """{"mu", "nu": zeros shaped like each param, "step": 0}."""
        def zeros(p):
            dt = torch_dtype(self.state_dtype) if self.state_dtype \
                else p.dtype
            return torch.zeros(p.shape, dtype=dt, device=p.device)

        return {"mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()},
                "step": 0}

    def scalars(self, step: int) -> tuple[float, float, float]:
        """(lr, 1 - b1^step, 1 - b2^step) at the incremented ``step``,
        each a float32 value."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        t = torch.tensor(step, dtype=torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32), t)
        return (float(torch.as_tensor(lr, dtype=torch.float32)), float(c1),
                float(c2))

    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor], decay: dict[str, bool]):
        """(updates, new state), as the reference returns them: each update
        in its param's dtype, each moment in its own dtype."""
        step = state["step"] + 1
        lr, c1, c2 = self.scalars(step)
        updates, mu, nu = {}, {}, {}
        for k, p in params.items():
            updates[k], mu[k], nu[k] = self._one(
                grads[k], state["mu"][k], state["nu"][k], p, lr, c1, c2,
                decay[k])
        return updates, {"mu": mu, "nu": nu, "step": step}

    def _one(self, g, mu, nu, p, lr, c1, c2, decay: bool):
        b1, b2 = self.b1, self.b2
        g32 = g.float()
        mu32 = mu.float() * b1 + (1 - b1) * g32
        nu32 = nu.float() * b2 + (1 - b2) * g32 * g32
        delta = (mu32 / c1) / (torch.sqrt(nu32 / c2) + self.eps)
        if self.weight_decay and decay:
            delta = delta + self.weight_decay * p.float()
        return ((-lr * delta).to(p.dtype), mu32.to(mu.dtype),
                nu32.to(nu.dtype))

    @torch.no_grad()
    def step_(self, grads: dict[str, torch.Tensor], state: dict,
              params: dict[str, torch.Tensor], decay: dict[str, bool]) -> None:
        """``update`` then ``apply_updates``, in place: each param, ``mu``
        and ``nu`` tensor is overwritten and ``state["step"]`` advanced."""
        step = state["step"] + 1
        lr, c1, c2 = self.scalars(step)
        for k, p in params.items():
            u, mu, nu = self._one(grads[k], state["mu"][k], state["nu"][k],
                                  p, lr, c1, c2, decay[k])
            p.add_(u)
            state["mu"][k].copy_(mu)
            state["nu"][k].copy_(nu)
        state["step"] = step


def apply_updates(params: dict[str, torch.Tensor],
                  updates: dict[str, torch.Tensor]) -> dict:
    """New params ``p + u`` in each param's dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}

"""Numerical realisation of the paper's theoretical construction (Sec 4.4 /
Appendix A.3) — the port of ``repro.core.theory``: self-attention weights
whose singular subspaces are grouped into N non-overlapping sets, so N
multiplexed streams are processed without interference.

The properties it realises:
  (i)   value independence:  <W_V u^(k), W_V u^(k')> ≈ 0 for k != k'
  (ii)  query-key separability: (W_K w)ᵀ(W_Q w) = Σ_k τ^(k) with each τ^(k)
        depending only on stream k
  (iii) head specialisation: zeroing singular values outside subspace k makes
        the head's attention pattern equal the single-stream pattern.

Random draws come from an explicit ``torch.Generator``; they follow the
reference's distributions, not its random bits.
"""
from __future__ import annotations

import torch

from repro_torch.nn import initializers


def make_subspace_basis(generator, d: int, n: int, *, device=None):
    """Orthonormal basis of R^d split into n groups of m = d // n columns.

    Returns R: (d, d) orthogonal; group k spans columns [k*m, (k+1)*m).
    """
    assert d % n == 0
    return initializers.random_orthogonal(d, generator=generator,
                                          device=device)


def project_to_subspace(x, basis, k: int, n: int):
    """Project x (…, d) onto subspace k — models φ^k mapping stream k into
    its own subspace (the construction's premise)."""
    m = basis.shape[0] // n
    bk = basis[:, k * m:(k + 1) * m]          # (d, m)
    return (x @ bk) @ bk.T


def _diag(values, rows: int):
    """A (rows, len(values)) matrix with ``values`` on its diagonal."""
    d = values.shape[0]
    out = torch.zeros((rows, d), dtype=values.dtype, device=values.device)
    out[torch.arange(d), torch.arange(d)] = values
    return out


def make_value_matrix(generator, basis, n: int, d_v: int | None = None):
    """W_V = L Σ Rᵀ with R = ``basis`` — right singular vectors grouped per
    subspace, L orthogonal ⇒ W_V maps the N input subspaces to N mutually
    orthogonal output subspaces (paper Eq. 9–12)."""
    d = basis.shape[0]
    d_v = d_v or d
    assert d_v >= d, "construction needs d_v >= d to keep all subspaces"
    left = initializers.random_orthogonal(d_v, generator=generator,
                                          device=basis.device)
    sv = 0.5 + torch.rand((d,), generator=generator, device=basis.device)
    return left @ _diag(sv, d_v) @ basis.T


def make_qk_matrices(generator, basis, n: int, d_k: int | None = None,
                     focus: int | None = None):
    """W_Q, W_K sharing left/right singular-space structure (paper Eq. 13–14).

    If ``focus`` is an index k, singular values outside subspace k are zeroed
    — the "head specialisation" option (τ^(k') = 0 for k' != k).
    """
    d = basis.shape[0]
    d_k = d_k or d
    assert d_k >= d
    m = d // n
    left = initializers.random_orthogonal(d_k, generator=generator,
                                          device=basis.device)

    def build():
        sv = 0.5 + torch.rand((d,), generator=generator, device=basis.device)
        if focus is not None:
            mask = torch.zeros((d,), device=basis.device)
            mask[focus * m:(focus + 1) * m] = 1.0
            sv = sv * mask
        return left @ _diag(sv, d_k) @ basis.T

    return build(), build()


def attention_head(q_w, k_w, v_w, x, *, scale=None):
    """Single attention head on a (L, d) sequence (paper Eq. 5)."""
    q = x @ q_w.T
    k = x @ k_w.T
    v = x @ v_w.T
    scale = scale or (q.shape[-1] ** -0.5)
    probs = torch.softmax((q @ k.T) * scale, dim=-1)
    return probs @ v, probs


def qk_tau(q_w, k_w, x_k):
    """τ^(k) contribution of one stream (projected input x_k, (L, d)):
    τ_{t,t'}^{(k)} = (W_K x_k[t'])ᵀ (W_Q x_k[t])."""
    return (x_k @ k_w.T) @ (x_k @ q_w.T).T

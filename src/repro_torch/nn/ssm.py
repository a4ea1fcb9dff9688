"""Mamba (S6) and xLSTM — the port of ``repro.nn.ssm``: ``MambaConfig``
and ``Mamba`` (arXiv:2312.00752, as used in Jamba, arXiv:2403.19887);
``XLSTMConfig``, ``MLSTM`` and ``SLSTM`` (arXiv:2405.04517).

The reference's SSM layers are plain ``jnp`` (they have no Pallas
kernel), and so are this port's: plain PyTorch on every device.  The
xLSTM mixers are described at ``XLSTMConfig`` below.

Modes, chosen by the arguments as in the reference:

  * full sequence (training / forward): ``cache is None``;
  * prefill: a cache is given and L > 1 — the full scan, whose final
    state and the last ``d_conv - 1`` rows of the conv input fill the
    cache;
  * decode: a cache is given and L == 1 — one recurrence step;
  * chunked decode: ``chunk_lens`` (B,) is given — L == C rows per slot,
    of which the first ``chunk_lens[b]`` advance slot b's state.

The full-sequence scan runs chunk by chunk (``cfg.chunk`` positions, the
sequence zero-padded to a multiple of the chunk, the padded steps having
delta 0: decay 1 and drive 0, so the state is carried through them
exactly), holding the (B, chunk, d_inner, d_state) float32 decay and drive
one chunk at a time as the reference does.  Where the reference combines
``(a_q * a_p, a_q * b_p + b_q)`` with ``lax.associative_scan``, the port
runs a log-depth (Hillis–Steele) scan with the same combine; the two
evaluate the products in another order, so they agree to float32
rounding, not bitwise.

The cache is {"ssm": (B, d_inner, d_state) float32, "conv": (B, d_conv -
1, d_inner) compute dtype}: O(1) per slot, whatever the sequence length.
Where the reference returns a new cache, the port writes the given one in
place and returns it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import initializers
from repro_torch.nn.layers import MLP, Linear, profiler_label


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """The reference's ``MambaConfig``, field for field."""
    dim: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(dim / 16)
    chunk: int = 128  # selective-scan chunk length

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, (self.dim + 15) // 16)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _scan(a, b):
    """Inclusive scan along axis 1 of h_t = a_t * h_{t-1} + b_t from h = 0,
    with the reference's combine ``(a_q * a_p, a_q * b_p + b_q)`` (p the
    earlier element): returns (prod a, h) at every step, in log2(L)
    rounds."""
    s, n = 1, a.shape[1]
    while s < n:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


class Mamba(nn.Module):
    """The selective state-space mixer: in_proj to (u, z), a causal
    depthwise conv over u, the input-dependent (delta, B, C), the scan, the
    D skip, the silu(z) gate and out_proj.  Parameters keep the reference's
    names and layouts (``conv_w`` (d_conv, d_inner), ``A_log`` (d_inner,
    d_state)); the Linears are stored (out, in)."""

    def __init__(self, cfg: MambaConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        di, ds, dr = cfg.d_inner, cfg.d_state, cfg.dt_rank_
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.in_proj = Linear(cfg.dim, 2 * di, **kw)
        self.conv_w = nn.Parameter(initializers.normal(
            (cfg.d_conv, di), 0.1, **kw))
        self.conv_b = nn.Parameter(torch.zeros(di, device=device,
                                               dtype=dtype))
        self.x_proj = Linear(di, dr + 2 * ds, **kw)
        self.dt_proj = Linear(dr, di, bias=True, **kw)
        # A = -[1..d_state] per channel (S4D-real init)
        self.A_log = nn.Parameter(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=device)).expand(di, ds)
            .to(dtype).clone())
        self.D = nn.Parameter(torch.ones(di, device=device, dtype=dtype))
        self.out_proj = Linear(di, cfg.dim, **kw)

    @staticmethod
    def init_cache(cfg: MambaConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
        return {
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
        }

    # -- shared pieces --------------------------------------------------------

    def _ssm_params(self, u):
        """u (..., d_inner) -> (delta (..., d_inner), B, C (..., d_state)),
        all float32."""
        dr, ds = self.cfg.dt_rank_, self.cfg.d_state
        dt, b, c = self.x_proj(u).split([dr, ds, ds], dim=-1)
        delta = _softplus(self.dt_proj(dt).float())
        return delta, b.float(), c.float()

    def _a(self):
        return -torch.exp(self.A_log.float())                 # (di, ds)

    def _causal_conv(self, u):
        w = self.conv_w.to(u.dtype)                           # (k, di)
        k, length = self.cfg.d_conv, u.shape[1]
        u_pad = F.pad(u, (0, 0, k - 1, 0))
        out = sum(u_pad[:, i:i + length] * w[i] for i in range(k))
        return out + self.conv_b.to(u.dtype)

    def _conv_step(self, conv_hist):
        """The conv output of the newest row of ``conv_hist`` (B, d_conv,
        d_inner), through silu."""
        w = self.conv_w.to(conv_hist.dtype)
        u = torch.einsum("bkd,kd->bd", conv_hist, w) + \
            self.conv_b.to(conv_hist.dtype)
        return F.silu(u)

    def _recur(self, u, ssm):
        """One recurrence step of (B, d_inner) inputs from state ``ssm``:
        -> (new state, y before the gate, float32)."""
        delta, bmat, cmat = self._ssm_params(u)
        decay = torch.exp(delta[..., None] * self._a())       # (B, di, ds)
        drive = (delta * u.float())[..., None] * bmat[:, None, :]
        h = decay * ssm + drive
        y = torch.einsum("bds,bs->bd", h, cmat)
        return h, y + self.D.float() * u.float()

    # -- modes ----------------------------------------------------------------

    def forward(self, x, *, cache=None, chunk_lens=None):
        """x: (B, L, dim) -> (y, cache).  Under a profiler the call runs
        inside the label ``mamba``."""
        with profiler_label("mamba"):
            if cache is not None and chunk_lens is not None:
                return self._chunked_decode(x, cache, chunk_lens)
            if cache is not None and x.shape[1] == 1:
                return self._decode_step(x, cache)
            return self._full(x, cache)

    def _full(self, x, cache):
        cfg = self.cfg
        b, length, _ = x.shape
        di, ds = cfg.d_inner, cfg.d_state
        u, z = self.in_proj(x).chunk(2, dim=-1)                # (B, L, di)
        u_raw = u
        u = F.silu(self._causal_conv(u))
        delta, bmat, cmat = self._ssm_params(u)
        a = self._a()

        ck = min(cfg.chunk, length)
        pad = (-length) % ck
        uf = F.pad(u, (0, 0, 0, pad)).float()
        delta, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                             for t in (delta, bmat, cmat))
        h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
        ys = []
        for s in range(0, length + pad, ck):
            uc, dc = uf[:, s:s + ck], delta[:, s:s + ck]
            bc, cc = bmat[:, s:s + ck], cmat[:, s:s + ck]
            decay = torch.exp(dc[..., None] * a)              # (B, ck, di, ds)
            drive = (dc * uc)[..., None] * bc[:, :, None, :]
            pa, pb = _scan(decay, drive)
            hs = pa * h[:, None] + pb
            ys.append(torch.einsum("blds,bls->bld", hs, cc))
            h = hs[:, -1]
        y = torch.cat(ys, dim=1)[:, :length]
        y = y + self.D.float() * u.float()
        y = y.to(x.dtype) * F.silu(z)
        if cache is not None:       # prefill: final state + conv history
            keep = cfg.d_conv - 1
            hist = F.pad(u_raw, (0, 0, max(0, keep - length), 0))[:, -keep:] \
                if keep else u_raw[:, :0]
            cache["ssm"].copy_(h)
            cache["conv"].copy_(hist)
        return self.out_proj(y), cache

    def _decode_step(self, x, cache):
        u, z = self.in_proj(x[:, 0]).chunk(2, dim=-1)          # (B, di)
        conv_hist = torch.cat([cache["conv"], u[:, None]], dim=1)
        u = self._conv_step(conv_hist)
        h, y = self._recur(u, cache["ssm"])
        y = y.to(x.dtype) * F.silu(z)
        cache["ssm"].copy_(h)
        cache["conv"].copy_(conv_hist[:, 1:])
        return self.out_proj(y)[:, None], cache

    def _chunked_decode(self, x, cache, chunk_lens):
        """Row-gated multi-token decode: the C rows go through the
        single-step recurrence in order, and a row ``i >= chunk_lens[b]``
        carries both of slot b's states (the float32 ssm state and the
        conv history) forward unchanged, so the slot ends where
        ``chunk_lens[b]`` one-token steps would leave it.  Rows past a
        slot's count still give (unused) outputs."""
        c = x.shape[1]
        row_ok = torch.arange(c, device=x.device)[None, :] < \
            torch.as_tensor(chunk_lens, device=x.device)[:, None]
        u_all, z_all = self.in_proj(x).chunk(2, dim=-1)       # (B, C, di)
        ssm, conv = cache["ssm"], cache["conv"]
        ys = []
        for t in range(c):
            conv_hist = torch.cat([conv, u_all[:, t, None]], dim=1)
            h, y = self._recur(self._conv_step(conv_hist), ssm)
            keep = row_ok[:, t, None, None]
            ssm = torch.where(keep, h, ssm)
            conv = torch.where(keep, conv_hist[:, 1:], conv)
            ys.append(y)
        y = torch.stack(ys, dim=1).to(x.dtype) * F.silu(z_all)
        cache["ssm"].copy_(ssm)
        cache["conv"].copy_(conv)
        return self.out_proj(y), cache


# ---------------------------------------------------------------------------
# xLSTM — arXiv:2405.04517 (mLSTM: matrix memory; sLSTM: scalar memory)
# ---------------------------------------------------------------------------
#
# Modes, as in the reference: with a cache and L == 1, one decode step from
# the cached state; with a cache and L > 1, a prefill whose recurrence
# starts from the zero state whatever the cache holds and whose final state
# fills the cache; without a cache, the full sequence.  The recurrence is
# stepwise, a Python loop over time like the reference's ``lax.scan``
# (exponential gating keeps a running max m, which breaks associativity),
# with float32 state.  Neither mixer has a row-gated (chunked decode)
# form, as in the reference.  The given cache is written in place and
# returned.


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """The reference's ``XLSTMConfig``, field for field.  ``chunk`` is read
    by nothing, there as here: both recurrences are stepwise."""
    dim: int
    n_heads: int = 4
    proj_factor: float = 2.0  # mLSTM block up-projection
    chunk: int = 64           # mLSTM scan chunk

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.dim)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def _xlstm_gates(logf, i_t, m):
    """Stabilised exponential gates: (m_new, input gate, forget gate) from
    log sigmoid(f), the input pre-activation and the running max."""
    m_new = torch.maximum(logf + m, i_t)
    return m_new, torch.exp(i_t - m_new), torch.exp(logf + m - m_new)


class MLSTM(nn.Module):
    """mLSTM block: up-projection to (u, z), the matrix-memory recurrence
    over heads of ``head_dim``, the output gate and silu(z), the
    down-projection.  Leaves keep the reference's names (``up``, ``wq``,
    ``wk``, ``wv``, ``wi``, ``wf``, ``wo``, ``down``; ``wi``, ``wf`` and
    ``wo`` with a bias).  State per head: C (hd, hd), n (hd), m ()."""

    def __init__(self, cfg: XLSTMConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, di, h = cfg.dim, cfg.d_inner, cfg.n_heads
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.up = Linear(d, 2 * di, **kw)
        self.wq = Linear(di, di, **kw)
        self.wk = Linear(di, di, **kw)
        self.wv = Linear(di, di, **kw)
        self.wi = Linear(di, h, bias=True, **kw)
        self.wf = Linear(di, h, bias=True, **kw)
        self.wo = Linear(di, di, bias=True, **kw)
        self.down = Linear(di, d, **kw)

    @staticmethod
    def init_cache(cfg: XLSTMConfig, batch: int, device=None) -> dict:
        h, hd = cfg.n_heads, cfg.head_dim
        f32 = dict(dtype=torch.float32, device=device)
        return {"C": torch.zeros((batch, h, hd, hd), **f32),
                "n": torch.zeros((batch, h, hd), **f32),
                "m": torch.full((batch, h), -1e30, **f32)}

    def _qkvgates(self, u):
        lead = u.shape[:-1]
        h, hd = self.cfg.n_heads, self.cfg.head_dim
        q = self.wq(u).reshape(*lead, h, hd)
        k = self.wk(u).reshape(*lead, h, hd) / (hd ** 0.5)
        v = self.wv(u).reshape(*lead, h, hd)
        return (q, k, v, self.wi(u).float(), self.wf(u).float(),
                torch.sigmoid(self.wo(u)))

    @staticmethod
    def _step(state, q, k, v, i_t, f_t):
        """One step of the recurrence: q, k, v (B, h, hd), i_t, f_t (B, h)
        -> (new state, h_t (B, h, hd) float32)."""
        c, n, m = state
        m_new, i_g, f_g = _xlstm_gates(F.logsigmoid(f_t), i_t, m)
        c = f_g[..., None, None] * c + \
            i_g[..., None, None] * (v[..., :, None] * k[..., None, :]).float()
        n = f_g[..., None] * n + i_g[..., None] * k.float()
        qf = q.float()
        num = (c @ qf[..., None])[..., 0]                  # bhvk,bhk->bhv
        den = torch.clamp_min((n * qf).sum(-1).abs(), 1.0)
        return (c, n, m_new), num / den[..., None]

    def forward(self, x, *, cache=None):
        """x: (B, L, dim) -> (y, cache).  Under a profiler the call runs
        inside the label ``mlstm``."""
        with profiler_label("mlstm"):
            b, length, _ = x.shape
            decode = cache is not None and length == 1
            u, z = self.up(x).chunk(2, dim=-1)
            q, k, v, it, ft, o = self._qkvgates(u)
            if decode:
                state = (cache["C"], cache["n"], cache["m"])
            else:                   # the full sequence, from the zero state
                state = tuple(self.init_cache(self.cfg, b, x.device).values())
            hs = []
            for t in range(length):
                state, h_t = self._step(state, q[:, t], k[:, t], v[:, t],
                                        it[:, t], ft[:, t])
                hs.append(h_t)
            hseq = torch.stack(hs, dim=1).reshape(b, length, self.cfg.d_inner)
            out = o * hseq.to(x.dtype) * F.silu(z)
            if cache is not None:
                for key, t in zip(("C", "n", "m"), state):
                    cache[key].copy_(t)
            return self.down(out), cache


class SLSTM(nn.Module):
    """sLSTM block: scalar-memory LSTM with exponential gating, then a
    gated GeGLU FFN (``ffn``, width int(4·dim/3), tanh GELU) added to its
    output.  Raw leaves as in the reference: ``wx`` (dim, 4·dim) for the
    gates i, f, z, o, ``wr`` (h, hd, 4·hd) recurrent per head, ``b``
    (4·dim).  The recurrent term is reshaped head-major to (B, 4·dim) and
    added to the gate-major input term before the split into i, f, z, o,
    as the reference does: with h heads, each gate's recurrent input comes
    from one head's hidden state, not from a block-diagonal per-head
    recurrence.  State per unit: c, n, m, h."""

    def __init__(self, cfg: XLSTMConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.dim, cfg.n_heads
        hd = d // h
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wx = nn.Parameter(initializers.normal((d, 4 * d), d ** -0.5,
                                                   **kw))
        self.wr = nn.Parameter(initializers.normal((h, hd, 4 * hd),
                                                   hd ** -0.5, **kw))
        self.b = nn.Parameter(torch.zeros(4 * d, device=device, dtype=dtype))
        self.ffn = MLP(d, int(4 * d / 3), gated=True, activation="gelu",
                       **kw)

    @staticmethod
    def init_cache(cfg: XLSTMConfig, batch: int, device=None) -> dict:
        f32 = dict(dtype=torch.float32, device=device)
        return {"c": torch.zeros((batch, cfg.dim), **f32),
                "n": torch.zeros((batch, cfg.dim), **f32),
                "m": torch.full((batch, cfg.dim), -1e30, **f32),
                "h": torch.zeros((batch, cfg.dim), **f32)}

    def _step(self, gx, state):
        """One step from the input term ``gx`` (B, 4·dim) -> (new state,
        h_t float32)."""
        c, n, m, hprev = state
        b = gx.shape[0]
        h = self.cfg.n_heads
        hp = hprev.to(gx.dtype).reshape(b, h, -1)
        gr = torch.einsum("bhd,hdk->bhk", hp,
                          self.wr.to(gx.dtype)).reshape(b, -1)
        gi, gf, gz, go = (gx + gr).float().chunk(4, dim=-1)
        m_new, i_g, f_g = _xlstm_gates(F.logsigmoid(gf), gi, m)
        c = f_g * c + i_g * torch.tanh(gz)
        n = f_g * n + i_g
        h_new = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
        return (c, n, m_new, h_new), h_new

    def forward(self, x, *, cache=None):
        """x: (B, L, dim) -> (y, cache).  Under a profiler the call runs
        inside the label ``slstm``."""
        with profiler_label("slstm"):
            b, length, _ = x.shape
            if cache is not None and length == 1:
                state = (cache["c"], cache["n"], cache["m"], cache["h"])
            else:                   # the full sequence, from the zero state
                state = tuple(self.init_cache(self.cfg, b, x.device).values())
            gx = x @ self.wx.to(x.dtype) + self.b.to(x.dtype)
            hs = []
            for t in range(length):
                state, h_t = self._step(gx[:, t], state)
                hs.append(h_t)
            y = torch.stack(hs, dim=1).to(x.dtype)
            if cache is not None:
                for key, t in zip(("c", "n", "m", "h"), state):
                    cache[key].copy_(t)
            return y + self.ffn(y), cache

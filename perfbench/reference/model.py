"""The plain reference: a float32 PyTorch model of each configuration.

It follows the configuration file (``configs/<name>.json``) and the
published description of each part, and imports nothing of the program:

* token embedding, and the index-embed prefix (Murahari et al. 2022,
  §3.2): instance i is preceded by N rows, ε^i at row i and ε^pad
  elsewhere;
* the Hadamard mux (§3.1): the mean over the N instances of v^i ⊙ x^i;
* pre-norm blocks: LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6); attention
  with RoPE (split halves, base ``rope_theta``), QKV bias where the
  configuration has it, bidirectional or causal; an MLP, GELU (tanh form)
  or SwiGLU;
* a final norm; the index-embed demux: a shared 2-layer MLP (GELU) on
  [h_j ; p^i], p^i the final hidden state at prefix row i;
* the task: LM logits (tied embedding or an output head) and their
  next-token loss, or a classifier on position 0; the retrieval loss of
  the instance drawn at each position (§3.3, Eq. 3), the draw given.

The repo's T-MUX departs from BERT, and the reference with it: RoPE in
place of learned positions, the tanh form of GELU.

``precision="fp32"`` computes in float32 with TF32 off.  ``"fp8"`` is the
control: the same model with every matrix product's operands rounded to
float8 e4m3, each row scaled by its absolute maximum, products summed in
float32 (the step below the configurations' bfloat16 that a faster path
would take).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0


def no_tf32() -> None:
    """Full float32 matrix products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_specs(model: dict, mux: dict, task: dict) -> list[tuple]:
    """(name, shape, init) of every weight, named as the program's
    ``state_dict`` names them (the classifier's head ``task_head.w``).
    ``init`` is ("normal", std), ("one", std): 1 + std·N(0, 1), for norm
    scales."""
    d, v = model["d_model"], model["vocab"]
    h, kv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    ff = model["d_ff"]
    n = mux["n"]
    hidden = mux.get("demux_hidden") or 2 * d
    layernorm = model["norm"] == "layernorm"
    specs = [("embed.table", (v, d), ("normal", 0.02))]

    def norm(prefix):
        specs.append((f"{prefix}.scale", (d,), ("one", 0.1)))
        if layernorm:
            specs.append((f"{prefix}.bias", (d,), ("normal", 0.1)))

    def linear(prefix, out_dim, in_dim, bias):
        specs.append((f"{prefix}.weight", (out_dim, in_dim),
                      ("normal", in_dim ** -0.5)))
        if bias:
            specs.append((f"{prefix}.bias", (out_dim,), ("normal", 0.02)))

    norm("final_norm")
    if not model["tie_embeddings"]:
        linear("lm_head", v, d, False)
    if n > 1:
        specs.append(("mux.v", (n, d), ("normal", 1.0)))
        specs.append(("demux.prefix_table", (n + 1, d), ("normal", 0.02)))
        linear("demux.mlp.l0", hidden, 2 * d, True)
        linear("demux.mlp.l1", d, hidden, True)
    for i in range(model["n_layers"]):
        p = f"layers.{i}"
        norm(f"{p}.norm1")
        for name, width in (("wq", h), ("wk", kv), ("wv", kv)):
            linear(f"{p}.attn.{name}", width * hd, d, model["qkv_bias"])
        linear(f"{p}.attn.wo", d, h * hd, False)
        norm(f"{p}.norm2")
        linear(f"{p}.mlp.up", ff, d, False)
        if model["gated_mlp"]:
            linear(f"{p}.mlp.gate", ff, d, False)
        linear(f"{p}.mlp.down", d, ff, False)
    if task["task"] == "cls":
        specs.append(("task_head.w", (d, task["n_classes"]),
                      ("normal", 0.02)))
    return specs


def fp8(x, dim: int = -1):
    """x rounded to float8 e4m3, scaled by its absolute maximum along
    ``dim``, back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The configuration's model over the given weights (any float dtype;
    read in float32)."""

    def __init__(self, config: dict, weights: dict, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.m, self.mux = config["model"], config["mux"]
        self.weights = weights
        self.precision = precision
        self.d = self.m["d_model"]
        self.hd = self.m.get("head_dim") or self.d // self.m["n_heads"]

    # -- pieces ---------------------------------------------------------------

    def w(self, name):
        return self.weights[name].float()

    def matmul(self, a, b):
        """a (..., k) @ b (k, n), the operands rounded under fp8 along k."""
        if self.precision == "fp8":
            a, b = fp8(a, -1), fp8(b, 0)
        return a @ b

    def linear(self, x, prefix: str, bias: bool = False):
        y = self.matmul(x, self.w(f"{prefix}.weight").T)
        if bias:
            y = y + self.w(f"{prefix}.bias")
        return y

    def norm(self, x, prefix: str):
        if self.m["norm"] == "layernorm":
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
            return (x - mean) * torch.rsqrt(var + 1e-5) * \
                self.w(f"{prefix}.scale") + self.w(f"{prefix}.bias")
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + 1e-6) * self.w(f"{prefix}.scale")

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))

    def rope(self, x, pos):
        """x (B, L, H, hd), pos (L,): the split halves rotated."""
        half = x.shape[-1] // 2
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attention(self, x, p: str, pos):
        """x (B, T, d) at positions ``pos`` (T,): causal attention reaches
        the rows at or before a row's position."""
        b, l, _ = x.shape
        h, kv, hd = self.m["n_heads"], self.m["n_kv_heads"], self.hd
        bias = self.m["qkv_bias"]
        q = self.linear(x, f"{p}.wq", bias).reshape(b, l, h, hd)
        k = self.linear(x, f"{p}.wk", bias).reshape(b, l, kv, hd)
        v = self.linear(x, f"{p}.wv", bias).reshape(b, l, kv, hd)
        q, k = self.rope(q, pos), self.rope(k, pos)
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, T, hd)
        s = self.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if self.m["causal"]:
            keep = pos[:, None] >= pos[None, :]
            s = s.masked_fill(~keep, float("-inf"))
        out = self.matmul(torch.softmax(s, dim=-1), v)
        return self.linear(out.transpose(1, 2).reshape(b, l, h * hd),
                           f"{p}.wo")

    def mlp(self, x, p: str):
        up = self.linear(x, f"{p}.up")
        if self.m["gated_mlp"]:
            hidden = F.silu(self.linear(x, f"{p}.gate")) * up
        elif self.m["activation"] == "gelu":
            hidden = self.gelu(up)
        else:
            raise ValueError(f"no reference for activation "
                             f"{self.m['activation']!r}")
        return self.linear(hidden, f"{p}.down")

    # -- the model --------------------------------------------------------------

    def prefix(self):
        """(N, P, d): instance i's prefix rows, ε^i at row i, ε^pad
        elsewhere."""
        n = self.mux["n"]
        table = self.w("demux.prefix_table")
        pre = table[n].expand(n, n, self.d).clone()
        idx = torch.arange(n, device=table.device)
        pre[idx, idx] = table[:n]
        return pre

    def mux_mean(self, x):
        """(B, N, T, d) -> (B, T, d): the mean over the N instances of
        v^i ⊙ x^i."""
        return (x * self.w("mux.v")[None, :, None]).mean(dim=1)

    def blocks(self, x, pos):
        """x (B, T, d) at positions ``pos`` through every block and the
        final norm."""
        for i in range(self.m["n_layers"]):
            p = f"layers.{i}"
            x = x + self.attention(self.norm(x, f"{p}.norm1"), f"{p}.attn",
                                   pos)
            x = x + self.mlp(self.norm(x, f"{p}.norm2"), f"{p}.mlp")
        return self.norm(x, "final_norm")

    def demux(self, rest, index):
        """rest (B, L, d), index embeddings (B, N, d) -> (B, N, L, d)."""
        b, l, d = rest.shape
        n = index.shape[1]
        z = torch.cat([rest[:, None].expand(b, n, l, d),
                       index[:, :, None].expand(b, n, l, d)], dim=-1)
        z = self.gelu(self.linear(z, "demux.mlp.l0", True))
        return self.linear(z, "demux.mlp.l1", True)

    def demuxed(self, tokens):
        """tokens (B, N, L) -> the demuxed states (B, N, L, d)."""
        n = self.mux["n"]
        b = tokens.shape[0]
        x = F.embedding(tokens, self.w("embed.table"))           # B N L d
        x = torch.cat([self.prefix()[None].expand(b, -1, -1, -1), x], dim=2)
        x = self.mux_mean(x)                                     # B P+L d
        h = self.blocks(x, torch.arange(x.shape[1], device=x.device))
        return self.demux(h[:, n:], h[:, :n])

    def stream(self, tokens, contrib, pos):
        """One slot's mixed stream as a server fed it: the prefix at
        positions 0..P-1, then row t at position ``pos[t]`` mixing the
        instances' ``tokens[t]`` (T, N) where ``contrib[t]`` (T, N) is 1.
        Returns (the T rows' final hidden states (T, d), the index
        embeddings (N, d))."""
        n = self.mux["n"]
        x = F.embedding(tokens, self.w("embed.table"))           # T N d
        x = x * contrib[..., None].float()
        x = torch.cat([self.prefix(), x.transpose(0, 1)], dim=1)  # N P+T d
        x = self.mux_mean(x[None])                               # 1 P+T d
        p = torch.cat([torch.arange(n, device=pos.device), pos])
        h = self.blocks(x, p)[0]
        return h[n:], h[:n]

    def logits(self, demuxed):
        """LM logits of demuxed rows (..., d) -> (..., V)."""
        head = "embed.table" if self.m["tie_embeddings"] else \
            "lm_head.weight"
        return self.matmul(demuxed, self.w(head).T)

    @staticmethod
    def nll(logits, labels):
        """Per-row negative log-likelihood, float32."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]

    def losses(self, demuxed, tokens, task: dict, labels=None, index=None):
        """(sum of the task's NLL, its count, sum of the retrieval NLL, its
        count) over a block of groups; the caller takes the means."""
        b, n, l, d = demuxed.shape
        if task["task"] == "lm":
            task_sum = 0.0
            for i in range(n):               # one instance's logits at a time
                for g in range(b):
                    lg = self.logits(demuxed[g, i, :-1])
                    task_sum += float(self.nll(lg, tokens[g, i, 1:]).sum())
            task_count = b * n * (l - 1)
        elif task["task"] == "cls":
            lg = self.matmul(demuxed[:, :, 0], self.w("task_head.w"))
            task_sum = float(self.nll(lg, labels).sum())
            task_count = b * n
        else:
            raise ValueError(f"no reference for task {task['task']!r}")
        retr_sum, retr_count = 0.0, 0
        if self.mux["retrieval_alpha"] > 0:
            sel = torch.gather(demuxed, 1,
                               index[:, None, :, None].expand(b, 1, l, d))[:, 0]
            tok = torch.gather(tokens, 1, index[:, None, :])[:, 0]
            for g in range(b):
                lg = self.matmul(sel[g], self.w("embed.table").T)
                retr_sum += float(self.nll(lg, tok[g]).sum())
            retr_count = b * l
        return task_sum, task_count, retr_sum, retr_count

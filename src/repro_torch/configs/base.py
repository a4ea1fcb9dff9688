"""Config system, the port's own copy of ``repro.configs.base``.

``MuxConfig`` and ``ServingConfig`` keep the reference's fields and
defaults, so one set of values describes a run in both packages.
``ModelConfig`` keeps the fields of the dense, MoE, hybrid, ssm, vlm and
audio families (MLA mixers included; Mamba mixers beside attention;
mLSTM and sLSTM mixers; cross-attention sublayers over a context and an
encoder stack), and the reference's ``remat`` and ``seq_parallel``.
Strategy names are validated against the port's own registry
(``repro_torch.core.strategies``).  ``ShapeConfig`` / ``INPUT_SHAPES`` are
the reference's input shapes, which the dry-run (``launch/dryrun.py``)
steps through.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.attention import AttnConfig, MLAConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.ssm import MambaConfig, XLSTMConfig

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(DTYPES)}") \
            from None


# ---------------------------------------------------------------------------
# DataMUX (paper technique) config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MuxConfig:
    """Data multiplexing — Murahari et al., NeurIPS 2022.

    n > 1 multiplexes n instances through one backbone stream.  n == 1 is a
    configured-but-inactive wrapper (identity semantics, used for baselines).
    """
    n: int = 1
    strategy: str = "hadamard"   # any registered mux strategy
    learned: bool = False        # unfreeze phi (paper A.5 "Learned")
    demux: str = "index_embed"   # any registered demux strategy
    demux_hidden: int = 0        # 0 -> 2 * d_model
    demux_layers: int = 2
    retrieval_alpha: float = 0.1  # aux retrieval loss weight (paper Eq. 4)
    use_kernel: bool = False      # fused CUDA mux/demux (strategies that
                                  # implement kernel_apply)
    prefix_pad: int = 0           # pad prefix to a multiple

    def __post_init__(self):
        # Imported lazily: strategies depend on repro_torch.nn, not the
        # other way around.
        from repro_torch.core import strategies
        if self.n < 1:
            raise ValueError(f"mux width n must be >= 1, got n={self.n}")
        strategies.get_mux(self.strategy)    # raises listing registered names
        strategies.get_demux(self.demux)

    @property
    def active(self) -> bool:
        return self.n > 1

    @property
    def prefix_len(self) -> int:
        """Prefix-protocol demuxers (``uses_prefix``, e.g. index_embed)
        prepend an N-token prefix (paper Sec 3.2), padded with ε^pad to a
        multiple of ``prefix_pad`` when that is set."""
        from repro_torch.core import strategies
        if not (self.active and strategies.get_demux(self.demux).uses_prefix):
            return 0
        p = self.n
        if self.prefix_pad:
            p += -p % self.prefix_pad
        return p


# ---------------------------------------------------------------------------
# Serving config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Decode-cache layout and scheduling knobs.  Same fields and defaults
    as ``repro.configs.base.ServingConfig``."""
    paged: bool = False
    page_size: int = 16
    pool_pages: int = 0
    use_kernel: bool = False  # paged decode attention through its kernel
    kblock_pages: int = 1
    fuse_demux: bool = False  # decode epilogue through the fused decode
                              # demux (index_embed, 2-layer MLP)
    prefill_chunk: int = 1
    policy: str = "fifo"
    preempt: bool = False
    slo_classes: tuple = (("latency", 8), ("batch", 64))
    min_residency_steps: int = 0
    replicas: int = 1
    router_policy: str = "round_robin"
    router_sync: bool = False
    width_set: tuple = ()
    width_policy: str = "static"
    max_preemptions: int = 0

    def __post_init__(self):
        for name in ("page_size", "kblock_pages", "prefill_chunk",
                     "replicas"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        for name in ("pool_pages", "min_residency_steps", "max_preemptions"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        for name in ("policy", "router_policy", "width_policy"):
            value = getattr(self, name)
            if not value or not isinstance(value, str):
                raise ValueError(
                    f"{name} must be a registered policy name, got {value!r}")
        widths = tuple(self.width_set)
        for w in widths:
            if not isinstance(w, int) or isinstance(w, bool) or w < 1:
                raise ValueError(
                    f"width_set members must be ints >= 1, got {w!r} in "
                    f"{widths}")
        if len(set(widths)) != len(widths):
            raise ValueError(f"duplicate widths in width_set {widths}")
        object.__setattr__(self, "width_set", tuple(sorted(widths)))
        if not self.slo_classes:
            raise ValueError("slo_classes needs at least one (name, "
                             "deadline) pair")
        names = [name for name, _ in self.slo_classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names in {names}")
        for name, deadline in self.slo_classes:
            if not name or not isinstance(name, str):
                raise ValueError(f"SLO class name must be a non-empty "
                                 f"string, got {name!r}")
            if int(deadline) < 1:
                raise ValueError(
                    f"SLO class {name!r} deadline must be >= 1 step, got "
                    f"{deadline}")


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
REMAT = ("none", "dots", "full")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    cite: str = ""
    head_dim: int = 0                # 0 -> d_model // n_heads
    window: int | None = None        # sliding window of the local layers
    global_every: int = 0            # every k-th layer is global (0: none)
    moe: MoEConfig | None = None
    moe_layer_start: int = 0         # layers < start are dense MLP
    moe_every: int = 1               # every k-th layer (within MoE region) is MoE
    mla: MLAConfig | None = None     # MLA (DeepSeek) mixers on every layer
    mamba: MambaConfig | None = None  # Mamba mixers (hybrid: beside attention)
    attn_every: int = 0              # hybrid: layer i is attention iff
    attn_offset: int = 0             # i % attn_every == attn_offset
    xlstm: XLSTMConfig | None = None  # xLSTM mixers (ssm family)
    slstm_every: int = 0             # layer i is sLSTM iff
                                     # (i + 1) % slstm_every == 0
    cross_attn_every: int = 0        # layer i has a cross-attention
                                     # sublayer iff i % cross_attn_every == 0
    context_dim: int = 0             # width of the context embeddings
    context_len: int = 0             # number of context embeddings
    encoder: ModelConfig | None = None  # encoder stack run over the context
    norm: str = "rmsnorm"
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    causal: bool = True
    mux: MuxConfig = dataclasses.field(default_factory=MuxConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "none"              # none | dots | full: activation
                                     # checkpointing of each scanned
                                     # layer-pattern group under autograd;
                                     # the reference defaults to "dots",
                                     # the port to "none" (ROADMAP Queue C)
    seq_parallel: bool = False       # the reference's Megatron-SP
                                     # constraint; refused on a mesh
                                     # (compute by gather shards no
                                     # activation over ``model``)

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got "
                             f"{self.remat!r}")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown model family {self.family!r}; the "
                             f"port runs {', '.join(FAMILIES)}")
        torch_dtype(self.dtype)
        torch_dtype(self.param_dtype)
        from repro_torch.core import strategies
        if self.mux.active:
            strategies.get_mux(self.mux.strategy).validate(
                self.mux, self.d_model)
        for w in self.serving.width_set:
            if w > self.mux.n:
                raise ValueError(
                    f"width_set member {w} exceeds the model's native mux "
                    f"width n={self.mux.n} (got width_set="
                    f"{self.serving.width_set})")
            if w > 1:
                try:
                    strategies.get_mux(self.mux.strategy).validate(
                        dataclasses.replace(self.mux, n=w), self.d_model)
                except ValueError as e:
                    raise ValueError(
                        f"width_set member {w} violates mux strategy "
                        f"{self.mux.strategy!r} constraints at d_model="
                        f"{self.d_model}: {e}") from e
        # The reference's K-block check (its VMEM budget), kept so that the
        # port takes exactly the kblock_pages the reference takes; it
        # applies, as there, only with the kernel on.
        if self.serving.paged and self.serving.use_kernel:
            from repro_torch.kernels.paged_attention.kernel import \
                validate_kblock
            validate_kblock(self.serving.kblock_pages,
                            self.serving.page_size, self.head_dim_,
                            itemsize=self.compute_dtype.itemsize)

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def attn_config(self, *, window: int | None = None,
                    use_flash: bool = False) -> AttnConfig:
        return AttnConfig(
            dim=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim_,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            causal=self.causal, window=window, use_flash=use_flash,
            paged_kernel=self.serving.use_kernel,
            kblock_pages=self.serving.kblock_pages)

    def layer_kinds(self) -> list[dict]:
        """Static per-layer structure, by the reference's rules: each
        layer's mixer is MLA when ``mla`` is set; with ``xlstm`` set it is
        sLSTM iff ``slstm_every`` and ``(i + 1) % slstm_every == 0``, and
        mLSTM otherwise; else, with ``mamba`` set, it is Mamba, or, with
        ``attn_every``, attention iff ``i % attn_every == attn_offset`` and
        Mamba otherwise; else attention.  An attention, MLA or Mamba mixer
        is followed by an MLP when ``d_ff`` or ``moe`` is set (an xLSTM
        block carries its own projections and has none); the MLP of
        layer i is MoE iff ``moe`` is set, ``i >= moe_layer_start`` and
        ``(i - moe_layer_start) % moe_every == 0``, and dense otherwise;
        with a ``window``, an attention layer i is global (no window) iff
        ``global_every`` and ``(i + 1) % global_every == 0``, and local
        (``window``) otherwise; layer i has a cross-attention sublayer iff
        ``cross_attn_every``, ``i % cross_attn_every == 0`` and
        ``context_len > 0``."""
        kinds = []
        for i in range(self.n_layers):
            mixer = "attn"
            if self.mla is not None:
                mixer = "mla"
            if self.xlstm is not None:
                mixer = "slstm" if (self.slstm_every and (i + 1) %
                                    self.slstm_every == 0) else "mlstm"
            elif self.mamba is not None:
                mixer = "attn" if (self.attn_every and i % self.attn_every
                                   == self.attn_offset) else "mamba"
            window = None
            if mixer == "attn" and self.window is not None and not (
                    self.global_every and (i + 1) % self.global_every == 0):
                window = self.window
            mlp = None
            if mixer in ("attn", "mla", "mamba") and (self.d_ff or self.moe):
                mlp = "dense"
                if (self.moe is not None and i >= self.moe_layer_start and
                        (i - self.moe_layer_start) % self.moe_every == 0):
                    mlp = "moe"
            cross = bool(self.cross_attn_every and
                         i % self.cross_attn_every == 0 and
                         self.context_len > 0)
            kinds.append(dict(mixer=mixer, mlp=mlp, window=window,
                              cross=cross))
        return kinds

    def layer_pattern(self) -> tuple[int, int, int]:
        """(head_len, period, n_groups) of the reference's layer stack:
        layers [0, head) run unscanned, then n_groups repeats of ``period``
        layers are scanned (their params stacked over groups), then the
        remainder runs unscanned.  The port runs a plain loop over its
        layers; ``bridge.decay_mask`` reads from this which of its tensors
        the reference stacks."""
        kinds = self.layer_kinds()
        n = self.n_layers
        best = (n, 1, 0)  # fully unscanned fallback
        for head in range(0, min(n, 8)):
            for period in range(1, 13):
                groups = 0
                while True:
                    s = head + (groups + 1) * period
                    if s > n:
                        break
                    if kinds[head + groups * period: s] != \
                            kinds[head: head + period]:
                        break
                    groups += 1
                if groups >= 2:
                    scanned = period * groups
                    best_scanned = best[1] * best[2]
                    if scanned > best_scanned or (
                            scanned == best_scanned and period < best[1]):
                        best = (head, period, groups)
        return best

    def param_count(self) -> int:
        """Approximate parameter count, the reference's arithmetic term
        for term (an encoder counts its own vocab embedding, which the
        encoder stack does not hold)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for k in self.layer_kinds():
            if k["mixer"] == "attn":
                hd = self.head_dim_
                total += d * (self.n_heads + 2 * self.n_kv_heads) * hd \
                    + self.n_heads * hd * d
            elif k["mixer"] == "mla":
                m = self.mla
                total += (d * m.q_lora_rank +
                          m.q_lora_rank * m.n_heads * m.qk_head_dim +
                          d * (m.kv_lora_rank + m.qk_rope_head_dim) +
                          m.kv_lora_rank * m.n_heads *
                          (m.qk_nope_head_dim + m.v_head_dim) +
                          m.n_heads * m.v_head_dim * d)
            elif k["mixer"] == "mamba":
                c = self.mamba
                di = c.d_inner
                total += d * 2 * di + c.d_conv * di + \
                    di * (c.dt_rank_ + 2 * c.d_state) + c.dt_rank_ * di + \
                    di * c.d_state + di + di * d
            elif k["mixer"] == "mlstm":
                c = self.xlstm
                di = c.d_inner
                total += d * 2 * di + 3 * di * di + 2 * di * c.n_heads + \
                    di * di + di * d
            elif k["mixer"] == "slstm":
                total += 4 * d * d + 4 * d * d // self.xlstm.n_heads + \
                    2 * d * int(4 * d / 3)
            if k["cross"]:
                hd = self.head_dim_
                total += (d * self.n_heads * hd +
                          2 * self.context_dim * self.n_kv_heads * hd +
                          self.n_heads * hd * d)
            if k["mlp"] == "dense":
                mult = 3 if self.gated_mlp else 2
                total += mult * d * self.d_ff
            elif k["mlp"] == "moe":
                m = self.moe
                mult = 3 if m.gated else 2
                total += m.n_experts * mult * d * m.moe_ff + d * m.n_experts
                total += m.n_shared_experts * mult * d * m.moe_ff
        if self.encoder is not None:
            total += self.encoder.param_count()
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed top-k experts),
        the reference's arithmetic."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        mult = 3 if m.gated else 2
        per_expert = mult * self.d_model * m.moe_ff
        n_moe_layers = sum(1 for k in self.layer_kinds() if k["mlp"] == "moe")
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Input shapes (the reference's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int   # instances; the backbone sees ceil(global_batch / N)
    kind: str           # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)

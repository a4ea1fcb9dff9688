"""Config system, the port's own copy of ``repro.configs.base``.

``MuxConfig`` and ``ServingConfig`` keep the reference's fields and
defaults, so one set of values describes a run in both packages.
``ModelConfig`` keeps the fields of the dense family, the only family the
port's backbone runs so far.  Strategy names are validated against the
port's own registry (``repro_torch.core.strategies``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.attention import AttnConfig

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
    as ``repro.configs.base.ServingConfig``.  The port serves every field
    but the replica router's (``replicas``, ``router_policy``,
    ``router_sync``)."""
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
# Model config (dense family)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # only "dense" so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    cite: str = ""
    head_dim: int = 0                # 0 -> d_model // n_heads
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

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(
                f"the port runs the dense family only so far, got family="
                f"{self.family!r} (ROADMAP Queue A item 9)")
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
        # The paged kernel stages kblock_pages pages of K and V in shared
        # memory: a stage that cannot fit fails here with the knob to turn,
        # not at the first launch mid-serve.  The plain version has no
        # stage, so the check applies only with the kernel on.
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

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            dim=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim_,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            causal=self.causal, paged_kernel=self.serving.use_kernel,
            kblock_pages=self.serving.kblock_pages)

    def layer_kinds(self) -> list[dict]:
        """Static per-layer structure.  Dense family: every layer is full
        attention (no window), followed by a dense MLP when ``d_ff`` is
        set."""
        mlp = "dense" if self.d_ff else None
        return [dict(mixer="attn", mlp=mlp, window=None)
                for _ in range(self.n_layers)]


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)

"""Pluggable mux/demux strategy registry (port of
``repro.core.strategies``).

  mux:   hadamard · ortho · lowrank · binary · identity   (paper Sec 3.1/A.5)
         nonlinear                                        (paper A.11, conv)
         rotation                                         (circular shift)
  demux: index_embed · mlp                                (paper Sec 3.2)

A strategy's ``init`` builds an ``nn.Module`` holding its parameters; the
strategy object itself is stateless and applies to that module.  Fused
paths hook in per strategy via ``kernel_apply`` + ``uses_kernel`` (see
``linear.HadamardMux``); demuxers that need the prefix protocol set
``uses_prefix`` (see ``demux.IndexEmbedDemux``).
"""
from repro_torch.core.strategies.base import DemuxStrategy, MuxStrategy
from repro_torch.core.strategies.registry import (get_demux, get_mux,
                                                  list_demux_strategies,
                                                  list_mux_strategies,
                                                  register_demux,
                                                  register_mux,
                                                  unregister_demux,
                                                  unregister_mux)

# Importing the builtin modules registers them.
from repro_torch.core.strategies import demux as _demux_builtins  # noqa: F401
from repro_torch.core.strategies import linear as _linear_builtins  # noqa: F401
from repro_torch.core.strategies import (  # noqa: F401
    nonlinear as _nonlinear_builtins, rotation as _rotation_builtins)

__all__ = [
    "MuxStrategy", "DemuxStrategy",
    "register_mux", "register_demux",
    "get_mux", "get_demux",
    "list_mux_strategies", "list_demux_strategies",
    "unregister_mux", "unregister_demux",
]

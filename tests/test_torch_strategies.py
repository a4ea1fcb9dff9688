"""Every mux and demux strategy of the port against the JAX package's, on
bridged weights: Backbone logits, and the width-narrowed params.  f32, atol
1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Backbone as JaxBackbone
from torch_parity import as_torch, bridged, configs, tokens

ATOL = 1e-4


@pytest.mark.parametrize("mux,demux", [("hadamard", "mlp"),
                                       ("ortho", "index_embed"),
                                       ("lowrank", "index_embed"),
                                       ("binary", "index_embed"),
                                       ("identity", "index_embed"),
                                       ("rotation", "index_embed"),
                                       ("nonlinear", "index_embed")])
def test_strategies_match_jax(mux, demux):
    jcfg, tcfg = configs("tmux", 4, mux={"strategy": mux, "demux": demux,
                                         "prefix_pad": 3})
    params, model = bridged(jcfg, tcfg, seed=1)
    toks = tokens(jcfg, 2, 5, seed=1)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = model(as_torch(toks))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)


def test_narrowed_strategies_match_jax():
    """``narrow`` gives the same width-w params as the reference's."""
    from repro.core import strategies as jax_strategies
    from repro_torch.core import strategies as torch_strategies
    jcfg, tcfg = configs("tmux", 4)
    params, model = bridged(jcfg, tcfg)
    for kind, tparams in (("mux", model.mux), ("demux", model.demux)):
        name = getattr(jcfg.mux, "strategy" if kind == "mux" else "demux")
        getter = "get_mux" if kind == "mux" else "get_demux"
        jn = getattr(jax_strategies, getter)(name).narrow(
            params[kind], jcfg.mux, 2)
        tn = getattr(torch_strategies, getter)(name).narrow(
            tparams, tcfg.mux, 2)
        for key, value in tn.state_dict().items():
            leaf = jn
            for part in key.split("."):
                leaf = leaf[{"weight": "w", "bias": "b"}.get(part, part)]
            want = np.asarray(leaf)
            if key.endswith("weight"):
                want = want.T
            np.testing.assert_array_equal(value.numpy(), want)

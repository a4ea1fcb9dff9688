"""The port's ``Backbone`` against the JAX package's ``Backbone.apply`` on
bridged weights: logits with and without ``last_only``, on a tmux-shaped
(bidirectional) and a qwen-shaped (causal, GQA) model, N ∈ {1, 2, 4}, with
the JAX side's fused Pallas mux/demux on (interpret mode); and the cache a
prefill fills.  f32, atol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Backbone as JaxBackbone
from torch_parity import as_torch, bridged, configs, tokens

ATOL = 1e-4


@pytest.mark.parametrize("arch", ["tmux", "qwen"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_apply_logits_match_jax(arch, n):
    jcfg, tcfg = configs(arch, n, mux={"use_kernel": True})
    params, model = bridged(jcfg, tcfg)
    toks = tokens(jcfg, 2, 7)
    with torch.no_grad():
        for last_only in (False, True):
            want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg,
                                     last_only=last_only)
            got = model(as_torch(toks), last_only=last_only)
            np.testing.assert_allclose(got["logits"].numpy(),
                                       np.asarray(want["logits"]),
                                       atol=ATOL, rtol=0)
            if n > 1:
                np.testing.assert_allclose(got["index_embeds"].numpy(),
                                           np.asarray(want["index_embeds"]),
                                           atol=ATOL, rtol=0)


def test_prefill_cache_matches_jax():
    """Forward with a cache (the serving prefill) fills it as the reference
    does, prefix rows included."""
    jcfg, tcfg = configs("qwen", 2, mux={"use_kernel": True})
    params, model = bridged(jcfg, tcfg)
    toks = tokens(jcfg, 2, 6)
    max_len = 6 + jcfg.mux.prefix_len + 3
    jcache = JaxBackbone.init_cache(jcfg, 2, max_len)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg, cache=jcache,
                             last_only=True)
    with torch.no_grad():
        got = model(as_torch(toks), cache=model.init_cache(2, max_len),
                    last_only=True)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=ATOL, rtol=0)
    jlayers = want["cache"]["head"] + [
        {k: v[g] for k, v in blk.items()}
        for g in range(len(want["cache"]["blocks"][0]["k"]))
        for blk in want["cache"]["blocks"]] + want["cache"]["tail"]
    assert len(jlayers) == len(got["cache"]) == tcfg.n_layers
    for jl, tl in zip(jlayers, got["cache"]):
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       atol=ATOL, rtol=0)

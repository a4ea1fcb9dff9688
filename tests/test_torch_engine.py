"""The port's lock-step ``Engine`` against the JAX package's on bridged
weights: prefill plus 4 teacher-forced steps, logits within 1e-4, with and
without the fused decode demux (``ServingConfig.fuse_demux``), the JAX
side's Pallas mux/demux kernels on (interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JaxEngine
from repro_torch.serving.engine import Engine
from torch_parity import as_torch, bridged, configs, tokens

ATOL = 1e-4
B, LP, STEPS = 2, 5, 4


@pytest.mark.parametrize("arch,n,fuse", [("tmux", 1, False),
                                         ("tmux", 2, True),
                                         ("tmux", 4, False),
                                         ("qwen", 2, False),
                                         ("qwen", 4, True)])
def test_teacher_forced_steps_match_jax(arch, n, fuse):
    jcfg, tcfg = configs(arch, n, mux={"use_kernel": True},
                         serving={"fuse_demux": fuse})
    params, model = bridged(jcfg, tcfg)
    prompts = tokens(jcfg, B, LP)
    forced = tokens(jcfg, B, STEPS, seed=1)        # (B, N, T) or (B, T)
    jeng = JaxEngine(params, jcfg, batch=B, max_len=LP + STEPS + 1)
    teng = Engine(model, batch=B, max_len=LP + STEPS + 1)
    want, jstate = jeng.prefill(jnp.asarray(prompts))
    got, tstate = teng.prefill(as_torch(prompts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for t in range(STEPS):
        tok = forced[..., t]
        want, jstate = jeng.step(jstate, jnp.asarray(tok))
        got, tstate = teng.step(tstate, as_torch(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    assert int(tstate.pos) == int(jstate.pos)


def test_vector_pos_and_lane_mask_match_jax():
    """A (B,) ``pos`` and a lane mask give the reference's logits."""
    jcfg, tcfg = configs("qwen", 4, mux={"use_kernel": True},
                         serving={"fuse_demux": True})
    params, model = bridged(jcfg, tcfg, seed=2)
    prompts = tokens(jcfg, B, LP, seed=2)
    jeng = JaxEngine(params, jcfg, batch=B, max_len=LP + 3)
    teng = Engine(model, batch=B, max_len=LP + 3)
    _, jstate = jeng.prefill(jnp.asarray(prompts))
    _, tstate = teng.prefill(as_torch(prompts))
    jstate.pos = jnp.full((B,), int(jstate.pos), jnp.int32)
    tstate.pos = torch.full((B,), int(tstate.pos), dtype=torch.int32)
    mask = np.array([[1, 1, 0, 1], [0, 1, 1, 1]], np.int32)
    for t in range(2):
        tok = tokens(jcfg, B, 1, seed=3 + t)[..., 0]
        want, jstate = jeng.step(jstate, jnp.asarray(tok),
                                 lane_mask=jnp.asarray(mask))
        got, tstate = teng.step(tstate, as_torch(tok),
                                lane_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        assert not got[0, 2].any() and not got[1, 0].any()
    assert tstate.pos.tolist() == [LP + jcfg.mux.prefix_len + 2] * B


@pytest.mark.parametrize("n", [1, 3])
def test_generate_matches_jax(n):
    """Greedy generation gives the reference's tokens (compared token for
    token at these seeds, not only in shape)."""
    jcfg, tcfg = configs("tmux", n, mux={"use_kernel": True},
                         serving={"fuse_demux": True})
    params, model = bridged(jcfg, tcfg, seed=3)
    prompts = tokens(jcfg, B, LP, seed=3)
    want = np.asarray(JaxEngine(params, jcfg, batch=B, max_len=LP + 4)
                      .generate(jnp.asarray(prompts), 3))
    got = Engine(model, batch=B, max_len=LP + 4).generate(
        as_torch(prompts), 3)
    assert tuple(got.shape) == want.shape == prompts.shape[:-1] + (4,)
    np.testing.assert_array_equal(got.numpy(), want)

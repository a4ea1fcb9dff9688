"""The port's image models (``repro_torch.models.image``), its remaining
mux strategies (``rotation``, ``nonlinear``), the theory construction
(``repro_torch.core.theory``) and the ``Multiplexer`` / ``Demultiplexer``
shims, against the JAX package.

* ``MuxMLP`` and ``MuxCNN`` at the paper's sizes (20x20, 10 classes,
  hidden 100, groups 20 / 84, N 4) with every registered mux strategy
  that validates at d 400, on weights bridged by
  ``bridge.image_params_from_jax``: logits within 1e-5 of the
  reference's, ``image_loss`` and every parameter's gradient within 1e-5
  x max(1, max|ref|); the reference's image cases on the port.
* The two strategies on their own: ``transform``, ``combine``, ``narrow``
  and the kernel flag against the reference; their validation errors
  (square width, colliding shifts) and the ``learned`` flag.
* The theory: ``tests/test_theory.py``'s properties on the port's own
  construction, and the port's functions against the reference's on one
  bridged basis and bridged matrices.
* The shims against the registry and the reference's shims.

Every test runs with one torch thread (the autouse fixture below).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MuxConfig as JaxMuxConfig
from repro.core import strategies as jax_strategies
from repro.core import theory as jax_theory
from repro.core.demultiplexer import Demultiplexer as JaxDemultiplexer
from repro.core.multiplexer import Multiplexer as JaxMultiplexer
from repro.data.images import SyntheticDigits as JaxDigits
from repro.models import image as jax_image
from repro_torch.bridge import image_params_from_jax
from repro_torch.configs import registry as torch_registry
from repro_torch.configs.base import MuxConfig
from repro_torch.core import strategies
from repro_torch.core import theory
from repro_torch.core.demultiplexer import Demultiplexer
from repro_torch.core.multiplexer import Multiplexer
from repro_torch.data.images import SyntheticDigits
from repro_torch.kernels import _build
from repro_torch.models import image

# Every registered mux strategy validates at d = 20² = 400 with N 4.
STRATEGIES = ["identity", "ortho", "lowrank", "binary", "hadamard",
              "rotation", "nonlinear"]
MODELS = {"MuxMLP": (image.MuxMLP, jax_image.MuxMLP),
          "MuxCNN": (image.MuxCNN, jax_image.MuxCNN)}
N = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol):
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= atol * max(1.0, float(np.abs(want).max())), err


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_model(model, strategy, seed=0):
    cfg = jax_image.ImageMuxConfig(n=N, strategy=strategy)
    jax_cls = MODELS[model][1]
    params = jax_cls.init(jax.random.PRNGKey(seed), cfg)
    return params, cfg, jax.jit(lambda p, x: jax_cls.apply(p, x, cfg))


def _bridged(model, strategy, seed=0):
    """(jax params, jax cfg, jitted reference apply, port model)."""
    params, jcfg, apply = _jax_model(model, strategy, seed)
    ours = MODELS[model][0](image.ImageMuxConfig(n=N, strategy=strategy),
                            device="cpu")
    ours.load_state_dict(image_params_from_jax(jax.tree.map(np.asarray,
                                                            params)),
                         strict=True)
    return params, jcfg, apply, ours


# ---------------------------------------------------------------------------
# the image models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_image_models_match_reference(model, strategy):
    """Logits (B 3, N 4, 20x20 -> (3, 4, 10)) within 1e-5 of the
    reference's on bridged weights; the mux launches no kernel."""
    params, jcfg, apply, ours = _bridged(model, strategy)
    x = _x((3, N, 20, 20), 1)
    want = apply(params, jnp.asarray(x))
    _build.LAUNCHES.clear()
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert tuple(got.shape) == (3, N, 10) and bool(got.isfinite().all())
    assert not _build.LAUNCHES
    _close(got, want, 1e-5)


@pytest.mark.parametrize("model,strategy", [("MuxMLP", "ortho"),
                                            ("MuxCNN", "nonlinear"),
                                            ("MuxCNN", "hadamard")])
def test_image_loss_and_grads_match_reference(model, strategy):
    """``image_loss`` (cross-entropy and accuracy) on a batch of the
    synthetic digits, and the gradient of the loss for every parameter
    (the nonlinear mux's conv nets among them: learned by default for an
    image config; the ortho matrices and hadamard vectors frozen), within
    1e-5 x max(1, max|ref|)."""
    params, jcfg, _, ours = _bridged(model, strategy)
    data = SyntheticDigits(noise=0.3).sample(8 * N,
                                             np.random.default_rng(0))
    imgs = data["images"].reshape(8, N, 20, 20)
    labels = data["labels"].reshape(8, N)

    def loss_fn(p):
        return jax_image.image_loss(MODELS[model][1].apply(
            p, jnp.asarray(imgs), jcfg), jnp.asarray(labels))
    (jloss, jacc), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, acc = image.image_loss(ours(torch.from_numpy(imgs)),
                                 torch.from_numpy(labels))
    loss.backward()
    _close(loss, jloss, 1e-5)
    assert float(acc) == float(jacc)
    want = image_params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(ours.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        if p.grad is None:                 # a frozen (detached) mux param
            assert not want[name].any(), name
            assert name.startswith("mux.") and strategy != "nonlinear"
        else:
            _close(p.grad, want[name].numpy(), 1e-5)
    if strategy == "nonlinear":
        assert got["mux.w1"].grad.abs().max() > 0


def test_the_cnn_keeps_the_references_padding_and_flatten_order():
    """``MuxCNN``'s 4x4 "SAME" convolution pads 1 before and 2 after (as
    XLA does), and its (120, 5, 5) map is flattened in H, W, C order:
    against ``lax.conv_general_dilated`` on one channel map, and the
    first rows of ``w`` read the first position's 120 channels."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 10, 7, 7), generator=g)
    w = torch.randn((4, 4, 10, 16), generator=g)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(w.numpy()),
        (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = image._conv_same(x, w).permute(0, 2, 3, 1)
    _close(got, want, 1e-5)
    params, jcfg, apply, ours = _bridged("MuxCNN", "identity")
    with torch.no_grad():
        ours.w[120:].zero_()              # only position (0, 0) is read
    trimmed = jax.tree.map(np.asarray, params)
    trimmed["w"] = trimmed["w"].copy()
    trimmed["w"][120:] = 0
    xs = _x((2, N, 20, 20), 3)
    with torch.no_grad():
        _close(ours(torch.from_numpy(xs)), apply(trimmed, jnp.asarray(xs)),
               1e-5)


def test_identity_baseline_confuses_order():
    """The reference's case on the port: the identity mux cannot tell
    instance order apart, so swapping the instances leaves the logits."""
    ours = image.MuxMLP(image.ImageMuxConfig(n=2, strategy="identity"),
                        device="cpu")
    x = torch.from_numpy(_x((1, 2, 20, 20), 4))
    with torch.no_grad():
        torch.testing.assert_close(ours(x), ours(x.flip(1)), rtol=1e-5,
                                   atol=1e-5)


def test_mlp_ortho_learns_quickly():
    """The reference's learning case on the port: an N 2 ortho MLP beats
    chance on the synthetic digits within 300 SGD steps (lr 0.1,
    cross-entropy)."""
    cfg = image.ImageMuxConfig(n=2, strategy="ortho")
    model = image.MuxMLP(cfg, device="cpu")
    data = SyntheticDigits(noise=0.3)
    rng = np.random.default_rng(0)
    opt = torch.optim.SGD([p for p in model.parameters()], lr=0.1)

    def batch(b):
        d = data.sample(b * cfg.n, rng)
        return (torch.from_numpy(d["images"].reshape(b, cfg.n, 20, 20)),
                torch.from_numpy(d["labels"].reshape(b, cfg.n)))
    for _ in range(300):
        imgs, labels = batch(32)
        loss, _ = image.image_loss(model(imgs), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
    imgs, labels = batch(64)
    with torch.no_grad():
        _, acc = image.image_loss(model(imgs), labels)
    assert float(acc) > 0.5, float(acc)          # chance = 0.1


def test_digits_are_the_references():
    ours, theirs = SyntheticDigits(), JaxDigits()
    np.testing.assert_array_equal(ours.templates, theirs.templates)
    a, b = ours.sample(16), theirs.sample(16)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


def test_image_config_validates_through_the_port_registry():
    """Unknown names list the port's registry; a width the strategy
    refuses raises at construction (rotation at d 4 < N 5, binary at d
    400 % 3); ``n`` below 1 raises; N 1 takes any strategy."""
    with pytest.raises(ValueError, match="registered"):
        image.ImageMuxConfig(n=2, strategy="no-such-mux")
    with pytest.raises(ValueError, match="d >= n"):
        image.ImageMuxConfig(n=5, strategy="rotation", size=2)
    with pytest.raises(ValueError, match="d % n"):
        image.ImageMuxConfig(n=3, strategy="binary")
    with pytest.raises(ValueError, match="must be >= 1"):
        image.ImageMuxConfig(n=0)
    cfg = image.ImageMuxConfig(n=1, strategy="binary", size=3)
    x = torch.from_numpy(_x((2, 1, 3, 3), 5))
    assert torch.equal(image.apply_image_mux(
        image.init_image_mux(cfg, generator=torch.Generator()), x, cfg),
        x.reshape(2, 9))


# ---------------------------------------------------------------------------
# the rotation and nonlinear strategies
# ---------------------------------------------------------------------------

def _strategy_pair(name, n=N, d=64, **mux):
    """(jax cfg, port cfg, jax params, port params bridged from them)."""
    jcfg = JaxMuxConfig(n=n, strategy=name, **mux)
    tcfg = MuxConfig(n=n, strategy=name, **mux)
    jp = jax_strategies.get_mux(name).init(jax.random.PRNGKey(0), jcfg, d)
    tp = strategies.get_mux(name).init(tcfg, d, generator=torch.Generator())
    tp.load_state_dict(image_params_from_jax(jax.tree.map(np.asarray, jp)),
                       strict=True)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ["rotation", "nonlinear"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_strategy_matches_reference(name, use_kernel):
    """``transform`` and ``apply`` (which is the plain ``combine`` whatever
    ``use_kernel`` says: neither has a kernel, and the launch counter
    stays at 0) within 1e-5 of the reference's at d 64, N 4, L 3; the
    port's parameter names and HWIO shapes are the reference's."""
    jcfg, tcfg, jp, tp = _strategy_pair(name, use_kernel=use_kernel)
    x = _x((2, N, 3, 64), 6)
    ours, theirs = strategies.get_mux(name), jax_strategies.get_mux(name)
    assert not ours.uses_kernel
    _build.LAUNCHES.clear()
    with torch.no_grad():
        got_t = ours.transform(tp, torch.from_numpy(x), tcfg)
        got = ours.apply(tp, torch.from_numpy(x), tcfg)
        assert torch.equal(got, ours.combine(tp, torch.from_numpy(x), tcfg))
    assert not _build.LAUNCHES
    _close(got_t, theirs.transform(jp, jnp.asarray(x), jcfg), 1e-5)
    _close(got, theirs.apply(jp, jnp.asarray(x), jcfg), 1e-5)
    if name == "nonlinear":
        assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == \
            {"w1": (N, 3, 3, 1, 16), "w2": (N, 3, 3, 16, 1)}
    else:
        assert not tp.state_dict()


@pytest.mark.parametrize("name", ["rotation", "nonlinear"])
def test_narrow_matches_reference(name):
    """``narrow`` to width 2: the nonlinear nets of the first two indices,
    rotation's shifts re-spread at the new width (parameter-free), both
    transforming as the reference's narrowed params do."""
    jcfg, tcfg, jp, tp = _strategy_pair(name)
    ours, theirs = strategies.get_mux(name), jax_strategies.get_mux(name)
    jn, tn = theirs.narrow(jp, jcfg, 2), ours.narrow(tp, tcfg, 2)
    x = _x((2, 2, 3, 64), 7)
    with torch.no_grad():
        got = ours.transform(tn, torch.from_numpy(x),
                             dataclasses.replace(tcfg, n=2))
    _close(got, theirs.transform(jn, jnp.asarray(x),
                                 dataclasses.replace(jcfg, n=2)), 1e-5)


def test_nonlinear_requires_square_width():
    with pytest.raises(ValueError, match="square"):
        strategies.get_mux("nonlinear").validate(MuxConfig(n=2), 32)
    with pytest.raises(ValueError, match="square"):
        dataclasses.replace(torch_registry.get_smoke_config("qwen1.5-4b"),
                            d_model=200, mux=MuxConfig(n=2,
                                                       strategy="nonlinear"))
    strategies.get_mux("nonlinear").validate(MuxConfig(n=2), 36)


def test_rotation_rejects_colliding_shifts():
    with pytest.raises(ValueError, match="d >= n"):
        strategies.get_mux("rotation").init(MuxConfig(n=4), 2)
    with pytest.raises(ValueError, match="d >= n"):
        dataclasses.replace(torch_registry.get_smoke_config("qwen1.5-4b"),
                            d_model=3, mux=MuxConfig(n=4,
                                                     strategy="rotation"))


@pytest.mark.parametrize("learned", [None, False, True])
def test_nonlinear_honors_learned_flag(learned):
    """A text ``MuxConfig`` freezes the conv nets at learned=False and
    trains them at learned=True; an image config, which has no such field,
    trains them."""
    d = 16
    cfg = image.ImageMuxConfig(n=2, strategy="nonlinear", size=4) \
        if learned is None else MuxConfig(n=2, strategy="nonlinear",
                                          learned=learned)
    s = strategies.get_mux("nonlinear")
    p = s.init(cfg, d, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((1, 2, 3, d), 8)).requires_grad_()
    (s.combine(p, x, cfg) ** 2).sum().backward()
    assert x.grad.abs().max() > 0
    if learned is False:
        assert p.w1.grad is None and p.w2.grad is None
    else:
        assert p.w1.grad.abs().max() > 0 and p.w2.grad.abs().max() > 0


def test_rotation_is_an_isometry_with_distinct_shifts():
    n, d = 4, 32
    cfg = MuxConfig(n=n, strategy="rotation")
    s = strategies.get_mux("rotation")
    x = torch.from_numpy(_x((2, n, 5, d), 9))
    t = s.transform(None, x, cfg)
    torch.testing.assert_close(t.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=0)
    same = x[:1, :1, :1].expand(1, n, 1, d)
    t = s.transform(None, same, cfg)
    for i in range(n):
        for j in range(i + 1, n):
            assert (t[0, i] - t[0, j]).abs().max() > 1e-4


def test_registry_lists_the_references_strategies():
    assert strategies.list_mux_strategies() == \
        jax_strategies.list_mux_strategies()
    assert strategies.list_demux_strategies() == \
        jax_strategies.list_demux_strategies()


# ---------------------------------------------------------------------------
# the theory construction (paper Sec 4.4, A.3)
# ---------------------------------------------------------------------------

def _streams(basis, n, length, seed):
    x = torch.from_numpy(_x((n, length, basis.shape[0]), seed))
    return torch.stack([theory.project_to_subspace(x[k], basis, k, n)
                        for k in range(n)])


@pytest.mark.parametrize("n", [2, 4])
def test_value_subspace_independence(n):
    """(i) <W_V u^(k), W_V u^(k')> ≈ 0 for k != k' (paper Eq. 6)."""
    g = torch.Generator().manual_seed(n)
    basis = theory.make_subspace_basis(g, 64, n)
    wv = theory.make_value_matrix(g, basis, n)
    v = torch.einsum("nld,ed->nle", _streams(basis, n, 8, 0), wv)
    for a in range(n):
        for b in range(a + 1, n):
            assert (v[a] @ v[b].T).abs().max() < 1e-4


@pytest.mark.parametrize("n", [2, 4])
def test_qk_decomposes_into_per_stream_tau(n):
    """(ii) (W_K w^{1:N})ᵀ(W_Q w^{1:N}) = Σ_k τ^(k) (paper Eq. 7/18)."""
    g = torch.Generator().manual_seed(10 + n)
    basis = theory.make_subspace_basis(g, 64, n)
    wq, wk = theory.make_qk_matrices(g, basis, n)
    u = _streams(basis, n, 6, 1)
    mixed = u.sum(dim=0)
    full = (mixed @ wk.T) @ (mixed @ wq.T).T
    tau = sum(theory.qk_tau(wq, wk, u[k]) for k in range(n))
    torch.testing.assert_close(full, tau, rtol=1e-3, atol=1e-3)


def test_head_specialisation():
    """(iii) singular values zeroed outside subspace k: the head's
    attention pattern on the mixture is the single stream's."""
    n, focus = 4, 2
    g = torch.Generator().manual_seed(20)
    basis = theory.make_subspace_basis(g, 64, n)
    wq, wk = theory.make_qk_matrices(g, basis, n, focus=focus)
    wv = theory.make_value_matrix(g, basis, n)
    u = _streams(basis, n, 8, 2)
    _, mixed = theory.attention_head(wq, wk, wv, u.sum(dim=0))
    _, solo = theory.attention_head(wq, wk, wv, u[focus])
    torch.testing.assert_close(mixed, solo, rtol=1e-3, atol=1e-3)


def test_projections_are_orthogonal_and_idempotent():
    n = 4
    basis = theory.make_subspace_basis(torch.Generator().manual_seed(30),
                                       64, n)
    torch.testing.assert_close(basis.T @ basis, torch.eye(64), rtol=0,
                               atol=1e-5)
    x = torch.from_numpy(_x((5, 64), 3))
    parts = [theory.project_to_subspace(x, basis, k, n) for k in range(n)]
    for a in range(n):
        for b in range(a + 1, n):
            assert (parts[a] @ parts[b].T).abs().max() < 1e-4
    again = theory.project_to_subspace(parts[1], basis, 1, n)
    torch.testing.assert_close(again, parts[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(sum(parts), x, rtol=0, atol=1e-4)


def test_theory_functions_match_reference_on_a_bridged_basis():
    """The reference's basis and matrices carried over: the port's
    projection, attention head and τ within 1e-5 of the reference's; the
    port's own W_V and W_Q, W_K on that basis have it as their right
    singular vectors (W R = L Σ has orthogonal columns), and the focused
    W_Q's singular values vanish outside its subspace."""
    n, d = 4, 32
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jbasis = jax_theory.make_subspace_basis(k1, d, n)
    jwq, jwk = jax_theory.make_qk_matrices(k2, jbasis, n)
    jwv = jax_theory.make_value_matrix(k3, jbasis, n)
    basis, wq, wk, wv = (torch.from_numpy(np.array(a))
                         for a in (jbasis, jwq, jwk, jwv))
    x = _x((6, d), 4)
    for k in range(n):
        _close(theory.project_to_subspace(torch.from_numpy(x), basis, k, n),
               jax_theory.project_to_subspace(jnp.asarray(x), jbasis, k, n),
               1e-5)
    out, probs = theory.attention_head(wq, wk, wv, torch.from_numpy(x))
    jout, jprobs = jax_theory.attention_head(jwq, jwk, jwv, jnp.asarray(x))
    _close(out, jout, 1e-5)
    _close(probs, jprobs, 1e-5)
    _close(theory.qk_tau(wq, wk, torch.from_numpy(x)),
           jax_theory.qk_tau(jwq, jwk, jnp.asarray(x)), 1e-5)
    g = torch.Generator().manual_seed(1)
    for w in (theory.make_value_matrix(g, basis, n, d_v=40),
              *theory.make_qk_matrices(g, basis, n, focus=1)):
        ls = w @ basis                      # L Σ: orthogonal columns
        gram = ls.T @ ls
        off = gram - torch.diag(torch.diagonal(gram))
        assert off.abs().max() < 1e-4
    wq1, _ = theory.make_qk_matrices(g, basis, n, focus=1)
    cols = (wq1 @ basis).norm(dim=0)
    m = d // n
    assert cols[:m].max() < 1e-5 and cols[2 * m:].max() < 1e-5
    assert cols[m:2 * m].min() >= 0.5 - 1e-5


# ---------------------------------------------------------------------------
# the Multiplexer / Demultiplexer shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hadamard", "ortho", "rotation",
                                  "nonlinear"])
def test_multiplexer_shim_matches_the_registry_and_reference(name):
    """``Multiplexer.init`` builds the strategy's params, ``transform`` and
    ``apply`` are the strategy's, and on bridged params both are the
    reference shim's within 1e-5."""
    jcfg, tcfg, jp, tp = _strategy_pair(name)
    ours = Multiplexer.init(tcfg, 64, generator=torch.Generator())
    assert ours.state_dict().keys() == tp.state_dict().keys()
    x = _x((2, N, 3, 64), 11)
    s = strategies.get_mux(name)
    with torch.no_grad():
        got = Multiplexer.apply(tp, torch.from_numpy(x), tcfg)
        assert torch.equal(got, s.apply(tp, torch.from_numpy(x), tcfg))
        got_t = Multiplexer.transform(tp, torch.from_numpy(x), tcfg)
    _close(got, JaxMultiplexer.apply(jp, jnp.asarray(x), jcfg), 1e-5)
    _close(got_t, JaxMultiplexer.transform(jp, jnp.asarray(x), jcfg), 1e-5)


@pytest.mark.parametrize("demux", ["index_embed", "mlp"])
def test_demultiplexer_shim_matches_the_registry_and_reference(demux):
    """``Demultiplexer.init`` / ``prefix_embeddings`` / ``apply`` are the
    strategy's, and on bridged params ``apply`` is the reference shim's
    within 1e-5 (the prefix rows bitwise)."""
    jcfg = JaxMuxConfig(n=N, demux=demux)
    tcfg = MuxConfig(n=N, demux=demux)
    d = 16
    jp = JaxDemultiplexer.init(jax.random.PRNGKey(0), jcfg, d)
    tp = Demultiplexer.init(tcfg, d, generator=torch.Generator())
    tp.load_state_dict(image_params_from_jax(jax.tree.map(np.asarray, jp)),
                       strict=True)
    h = _x((2, 5, d), 12)
    ie = _x((2, N, d), 13) if demux == "index_embed" else None
    kw = {} if ie is None else {"index_embeds": torch.from_numpy(ie)}
    with torch.no_grad():
        got = Demultiplexer.apply(tp, torch.from_numpy(h), tcfg, **kw)
        assert torch.equal(got, strategies.get_demux(demux).apply(
            tp, torch.from_numpy(h), tcfg, **kw))
    want = JaxDemultiplexer.apply(
        jp, jnp.asarray(h), jcfg,
        index_embeds=None if ie is None else jnp.asarray(ie))
    assert tuple(got.shape) == (2, N, 5, d)
    _close(got, want, 1e-5)
    if demux == "index_embed":
        np.testing.assert_array_equal(
            _np(Demultiplexer.prefix_embeddings(tp, tcfg, torch.float32)),
            np.asarray(JaxDemultiplexer.prefix_embeddings(jp, jcfg,
                                                          jnp.float32)))

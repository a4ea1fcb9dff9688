"""The port's replica router: the cases of the JAX package's
``tests/test_router.py`` through ``repro_torch`` (bridged weights), the
JAX router reproduced count for count, the weight-sharing config view the
router builds replicas from, the counts (and their bitwise flags) recorded
in ``results/bench/serving_router.json``, ``width_classes.json`` and
``serving_preempt.json``, read from the committed files, and the serve
launcher's router path on the CPU."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import Backbone as JaxBackbone
from repro.serving.router import ReplicaRouter as JaxRouter
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ServingConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import Backbone
from repro_torch.serving.engine import Engine
from repro_torch.serving.router import (LeastLoadedRouting, ReplicaRouter,
                                        RoutingPolicy, get_routing,
                                        list_routing, register_routing,
                                        unregister_routing)
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           SchedulerStats, poisson_trace)
from repro_torch.serving.telemetry import Tracer, trace_summary


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RESULTS = Path(__file__).resolve().parents[1] / "results" / "bench"


def _cfg(n=2, **serving):
    cfg = get_smoke_config("qwen1.5-4b", mux_n=n)
    if serving:
        return dataclasses.replace(cfg, serving=ServingConfig(**serving))
    return cfg


def _model(cfg):
    """``cfg``'s Backbone on the CPU with weights the JAX package drew
    (PRNGKey(0)) and the bridge carried over."""
    from repro.configs.registry import get_smoke_config as jax_smoke
    jcfg = jax_smoke("qwen1.5-4b", mux_n=cfg.mux.n)
    params = JaxBackbone.init(jax.random.PRNGKey(0), jcfg)
    model = Backbone(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg), strict=True)
    return model.eval()


def _requests(spec, *, vocab=512, seed=0):
    """spec: list of (lp, gen, arrival) or (lp, gen, arrival, slo)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(spec):
        lp, gen, arr = s[:3]
        slo = s[3] if len(s) > 3 else ""
        out.append(Request(
            rid=i, prompt=rng.integers(0, vocab, lp).astype(np.int32),
            max_new_tokens=gen, arrival=arr, slo=slo))
    return out


def _fresh(reqs):
    return [r.fresh() for r in reqs]


def _outputs(router_or_sched):
    return {q.rid: list(q.output) for q in router_or_sched.finished}


# ---------------------------------------------------------------------------
# the cases of tests/test_router.py
# ---------------------------------------------------------------------------

def test_single_replica_router_bitwise_identical():
    """A 1-replica round-robin router reproduces the bare scheduler's token
    stream, step count and TTFTs bitwise on the same trace."""
    cfg = _cfg()
    model = _model(cfg)
    trace = poisson_trace(10, rate=1.5, prompt_len=3, gen_len=4,
                          vocab=cfg.vocab, max_total=40, seed=3)
    sched = ContinuousScheduler(Engine(model, batch=2, max_len=40))
    bare_stats = sched.run(_fresh(trace))
    router = ReplicaRouter.build(model, batch=2, max_len=40, replicas=1,
                                 policy="round_robin")
    r_stats = router.run(_fresh(trace))

    assert _outputs(router) == _outputs(sched)
    assert r_stats.decode_steps == bare_stats.decode_steps
    assert r_stats.generated_tokens == bare_stats.generated_tokens
    assert {q.rid: q.ttft for q in router.finished} == \
        {q.rid: q.ttft for q in sched.finished}
    assert r_stats.requeues == 0


def test_least_loaded_bounds_page_spread():
    """Long and short generations alternating: round-robin funnels every
    long request to one replica, ``least_loaded`` spreads them, so its
    per-replica peak-page spread is strictly smaller."""
    cfg = _cfg(paged=True, page_size=4, pool_pages=33)
    model = _model(cfg)
    spec = [(2, 24 if i % 2 == 0 else 2, 2 * i) for i in range(8)]
    trace = _requests(spec, vocab=cfg.vocab)

    def peaks(policy):
        router = ReplicaRouter.build(model, batch=2, max_len=64, replicas=2,
                                     policy=policy)
        stats = router.run(_fresh(trace))
        assert stats.finished == len(trace)
        return [p["peak_pages"] for p in stats.per_replica]

    rr, ll = peaks("round_robin"), peaks("least_loaded")
    assert max(ll) - min(ll) < max(rr) - min(rr), (ll, rr)


def test_backpressure_requeues_not_drops():
    """A burst beyond the fleet's lanes backpressures at the router; every
    rid still completes with its full token budget."""
    cfg = _cfg()
    model = _model(cfg)
    trace = _requests([(2, 5, 0)] * 12, vocab=cfg.vocab)
    router = ReplicaRouter.build(model, batch=2, max_len=32, replicas=2,
                                 policy="least_loaded")
    stats = router.run(_fresh(trace))

    assert stats.requeues > 0
    assert stats.finished == len(trace)
    got = _outputs(router)
    assert set(got) == {r.rid for r in trace}
    for r in trace:
        assert len(got[r.rid]) == r.max_new_tokens
    assert sum(stats.dispatched) == len(trace)


def test_heterogeneous_replicas_and_fast_fail():
    """A paged replica next to a contiguous one, both over one set of
    weights: a request only one replica can ever hold routes there, and a
    request no replica can hold fails fast at ``submit``."""
    cfg = _cfg()
    model = _model(cfg)
    paged = ServingConfig(paged=True, page_size=4, pool_pages=40)
    r0 = ContinuousScheduler(Engine(model, batch=1, max_len=16))
    r1 = ContinuousScheduler(Engine(
        model.with_config(dataclasses.replace(cfg, serving=paged)), batch=1,
        max_len=64))
    router = ReplicaRouter([r0, r1], policy="least_loaded")

    fits_both = _requests([(2, 3, 0)], vocab=cfg.vocab)[0]
    fits_r1 = dataclasses.replace(_requests([(2, 30, 0)],
                                            vocab=cfg.vocab)[0], rid=1)
    stats = router.run([fits_both.fresh(), fits_r1.fresh()])
    assert stats.finished == 2
    assert any(q.rid == 1 for q in r1.finished)

    too_big = dataclasses.replace(_requests([(2, 200, 0)],
                                            vocab=cfg.vocab)[0], rid=2)
    with pytest.raises(ValueError, match="fits none"):
        router.submit(too_big.fresh())


def test_sync_mode_steps_all_replicas():
    cfg = _cfg()
    model = _model(cfg)
    trace = poisson_trace(8, rate=2.0, prompt_len=2, gen_len=3,
                          vocab=cfg.vocab, max_total=32, seed=1)
    router = ReplicaRouter.build(model, batch=1, max_len=32, replicas=2,
                                 policy="round_robin", sync=True)
    stats = router.run(_fresh(trace))
    assert stats.finished == 8
    steps = [p["decode_steps"] for p in stats.per_replica]
    assert steps[0] == steps[1] == stats.router_steps


def test_routing_registry_roundtrip():
    assert {"round_robin", "least_loaded", "slo_headroom"} <= \
        set(list_routing())
    assert get_routing("least_loaded") is LeastLoadedRouting
    with pytest.raises(ValueError, match="unknown routing policy"):
        get_routing("nope")

    @register_routing("test_always_zero")
    class AlwaysZero(RoutingPolicy):
        def select(self, req, candidates):
            return candidates[0][0] if candidates else None

    try:
        assert get_routing("test_always_zero") is AlwaysZero
        with pytest.raises(ValueError, match="already registered"):
            register_routing("test_always_zero")(AlwaysZero)
    finally:
        unregister_routing("test_always_zero")


def test_slo_headroom_routes_latency_to_headroom():
    """A latency-class arrival goes to the replica with more admission
    headroom (fewer batch lanes), though both have free lanes."""
    cfg = _cfg(policy="slo")
    model = _model(cfg)
    warm = _requests([(2, 20, 0, "batch"), (2, 20, 0, "batch"),
                      (2, 20, 1, "batch")], vocab=cfg.vocab)
    lat = dataclasses.replace(
        _requests([(2, 2, 3, "latency")], vocab=cfg.vocab)[0], rid=3)
    router = ReplicaRouter.build(model, batch=1, max_len=40, replicas=2,
                                 policy="slo_headroom")
    stats = router.run(_fresh(warm) + [lat.fresh()])
    assert stats.finished == 4
    holder = [i for i, s in enumerate(router.replicas)
              if any(q.rid == 3 for q in s.finished)][0]
    loads = [sum(1 for q in s.finished if q.slo == "batch")
             for s in router.replicas]
    assert loads[holder] == min(loads)


def test_report_lines_robust_to_empty_classes():
    lines = serve._report_lines(SchedulerStats())
    assert any("n/a" in ln for ln in lines)
    assert any("no SLO classes" in ln for ln in lines)

    cfg = _cfg(policy="slo")
    model = _model(cfg)
    sched = ContinuousScheduler(Engine(model, batch=1, max_len=32))
    stats = sched.run(_fresh(_requests([(2, 3, 0, "latency")],
                                       vocab=cfg.vocab)))
    lines = serve._report_lines(stats)
    assert any("latency" in ln for ln in lines)
    assert all("n/a" not in ln for ln in lines if "latency" in ln)

    router = ReplicaRouter.build(model, batch=1, max_len=32, replicas=2)
    r_stats = router.run(_fresh(_requests([(2, 3, 0)], vocab=cfg.vocab)))
    assert serve._report_lines(r_stats)


# ---------------------------------------------------------------------------
# against the JAX router; the shared weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,sync", [("least_loaded", False),
                                         ("slo_headroom", False),
                                         ("round_robin", True)])
def test_router_matches_jax_router(policy, sync):
    """The same trace through both routers (R = 2, paged next to
    contiguous): router steps, per-replica decode and idle steps,
    dispatch, requeues and every TTFT identical (the trace has no EOS, so
    none depends on the sampled tokens)."""
    from repro.configs.base import ServingConfig as JaxServingConfig
    from repro.configs.registry import get_smoke_config as jax_smoke

    cfg = _cfg(policy="slo")
    jcfg = dataclasses.replace(jax_smoke("qwen1.5-4b", mux_n=2),
                               serving=JaxServingConfig(policy="slo"))
    paged = dict(paged=True, page_size=4, policy="slo")
    model = _model(cfg)
    params = JaxBackbone.init(jax.random.PRNGKey(0), jcfg)
    trace = poisson_trace(16, rate=2.0, prompt_len=3, gen_len=4,
                          vocab=cfg.vocab, max_total=30, seed=2, slo_mix=0.4)
    ours = ReplicaRouter.build(model, batch=2, max_len=30, replicas=2,
                               overrides={1: ServingConfig(**paged)},
                               policy=policy, sync=sync)
    theirs = JaxRouter.build(params, jcfg, batch=2, max_len=30, replicas=2,
                             overrides={1: JaxServingConfig(**paged)},
                             policy=policy, sync=sync)
    got, want = ours.run(_fresh(trace)), theirs.run(_fresh(trace))
    for key in ("router_steps", "idle_steps", "requeues", "dispatched",
                "finished", "generated_tokens", "decode_steps",
                "ttft_p50", "ttft_p99"):
        assert getattr(got, key) == getattr(want, key), key
    for a, b in zip(got.per_replica, want.per_replica):
        for key in ("dispatched", "finished", "decode_steps", "idle_steps",
                    "peak_pages"):
            assert a[key] == b[key], key
    assert {q.rid: q.ttft for q in ours.finished} == \
        {q.rid: q.ttft for q in theirs.finished}


def test_replicas_share_one_set_of_weights():
    """``build`` serves every replica from the one model: an override is a
    ``with_config`` view whose every parameter is the model's own tensor,
    its attention taking the override's paged-kernel settings; a view that
    would reshape the weights is refused."""
    cfg = _cfg()
    model = _model(cfg)
    paged = ServingConfig(paged=True, page_size=4, use_kernel=True,
                          kblock_pages=2)
    router = ReplicaRouter.build(model, batch=1, max_len=16, replicas=3,
                                 overrides={2: paged})
    base, view = (router.replicas[0].engine.model,
                  router.replicas[2].engine.model)
    assert base is model and router.replicas[1].engine.model is model
    assert view is not model and view.cfg.serving == paged
    ours = dict(model.named_parameters())
    theirs = dict(view.named_parameters())
    assert ours.keys() == theirs.keys()
    assert all(theirs[k] is ours[k] for k in ours)
    assert view.layers[0].attn.cfg.paged_kernel
    assert view.layers[0].attn.cfg.kblock_pages == 2
    assert not model.layers[0].attn.cfg.paged_kernel
    kernel = dataclasses.replace(cfg, mux=dataclasses.replace(
        cfg.mux, use_kernel=True))
    assert model.with_config(kernel).cfg.mux.use_kernel
    for bad in (dataclasses.replace(cfg, n_layers=2),
                dataclasses.replace(cfg, mux=dataclasses.replace(cfg.mux,
                                                                 n=4)),
                dataclasses.replace(cfg, causal=False)):
        with pytest.raises(ValueError, match="may change only"):
            model.with_config(bad)


# ---------------------------------------------------------------------------
# results/bench/{serving_router,width_classes,serving_preempt}.json
# ---------------------------------------------------------------------------

def _committed(name):
    return json.loads((RESULTS / f"{name}.json").read_text())


def _micro(n: int, **serving):
    """The benchmarks' micro config (tmux smoke, 2 layers, vocab 128);
    counts do not depend on the weights (the traces have no EOS)."""
    cfg = dataclasses.replace(get_smoke_config("tmux-12l-768h", mux_n=n),
                              n_layers=2, vocab=128,
                              serving=ServingConfig(**serving))
    return Backbone(cfg, device="cpu").eval()


def test_bench_serving_router_counts():
    """``benchmarks/router.py`` through the port: the R = 1 round-robin
    router bitwise the bare scheduler, then least_loaded at R = 1, 2, 4 —
    router and decode steps, tokens, requeues, dispatch, lane use, and the
    R = 2 run's telemetry summary."""
    want = _committed("serving_router")
    c = want["config"]
    model = _micro(c["n"])
    max_total = 2 * c["prompt_len"] + 4 * c["gen_len"] + 1
    trace = poisson_trace(c["num_requests"], rate=c["rate"],
                          prompt_len=c["prompt_len"], gen_len=c["gen_len"],
                          vocab=128, max_total=max_total, seed=c["seed"])
    sched = ContinuousScheduler(Engine(model, batch=c["batch"],
                                       max_len=max_total))
    sched.run(_fresh(trace))
    router1 = ReplicaRouter.build(model, batch=c["batch"], max_len=max_total,
                                  replicas=1, policy="round_robin")
    router1.run(_fresh(trace))
    assert (_outputs(router1) == _outputs(sched)) is \
        want["bitwise_r1_vs_bare"] is True
    for r in (1, 2, 4):
        tracer = Tracer() if r == 2 else None
        router = ReplicaRouter.build(model, batch=c["batch"],
                                     max_len=max_total, replicas=r,
                                     policy=c["policy"], tracer=tracer)
        stats = router.run(_fresh(trace))
        rec = want["replicas"][f"r{r}"]
        got = {"router_steps": stats.router_steps,
               "decode_steps": stats.decode_steps,
               "generated_tokens": stats.generated_tokens,
               "tok_per_step": round(stats.tokens_per_step, 3),
               "ttft": {"p50": round(stats.ttft_p50, 1),
                        "p99": round(stats.ttft_p99, 1)},
               "requeues": stats.requeues, "dispatched": stats.dispatched,
               "lane_util": [round(p["load"]["free_lanes"]
                                   / max(1, p["load"]["total_lanes"]), 2)
                             for p in stats.per_replica]}
        assert got == {k: rec[k] for k in got}, f"R={r}"
        if tracer is not None:
            assert trace_summary(tracer) == rec["telemetry"]


def test_bench_width_class_counts():
    """``benchmarks/width_classes.py`` through the port: width_set={N}
    bitwise the fixed-N scheduler with no variant built, then the n1, n4
    and mixed {1, 4} fleets' steps, tokens, per-width counts and the mixed
    fleet's telemetry summary."""
    want = _committed("width_classes")
    c = want["config"]
    n, batch = c["n"], c["batch"]
    max_total = 2 * c["prompt_len"] + 4 * c["gen_len"] + 1
    trace = poisson_trace(c["num_requests"], rate=c["rate"],
                          prompt_len=c["prompt_len"], gen_len=c["gen_len"],
                          vocab=128, max_total=max_total, seed=c["seed"],
                          slo_mix=c["slo_mix"])
    model4 = _micro(n, policy="slo")

    def run(model, tracer=None):
        eng = Engine(model, batch=batch, max_len=max_total)
        sched = ContinuousScheduler(eng, tracer=tracer)
        return eng, sched, sched.run(_fresh(trace))

    _, fixed, fixed_stats = run(model4)
    single_eng, single, single_stats = run(model4.with_config(
        dataclasses.replace(model4.cfg, serving=ServingConfig(
            policy="slo", width_set=(n,)))))
    bitwise = (_outputs(single) == _outputs(fixed)
               and single_stats.decode_steps == fixed_stats.decode_steps)
    assert bitwise is want["bitwise_single_class_vs_fixed"] is True
    assert single_eng.variant_compiles == 0

    mixed = model4.with_config(dataclasses.replace(
        model4.cfg, serving=ServingConfig(policy="slo", width_set=(1, n),
                                          width_policy="slo_tiered")))
    for label, model, tracer in (("n1", _micro(1, policy="slo"), None),
                                 (f"n{n}", model4, None),
                                 ("mixed", mixed, Tracer())):
        eng, sched, stats = run(model, tracer)
        rec = want["fleets"][label]
        assert stats.finished == c["num_requests"]
        assert sum(cl.width * cl.n_slots for cl in sched.classes) == \
            rec["lanes"]
        assert stats.decode_steps == rec["decode_steps"], label
        assert stats.generated_tokens == rec["generated_tokens"], label
        assert eng.variant_compiles == rec["variant_compiles"], label
        for w, pw in rec["per_width"].items():
            ours = stats.per_width[int(w)]
            for key in ("count", "tokens", "preempted"):
                assert ours[key] == pw[key], (label, w, key)
            assert round(ours["ttft_mean"], 2) == pw["ttft_mean"]
        if tracer is not None:
            assert trace_summary(tracer) == rec["telemetry"]


def _two_class_trace(c):
    """``benchmarks/paging.py``'s two Poisson processes: long batch-class
    generations, short latency-class ones on top of them."""
    batch = poisson_trace(c["n_batch"], rate=c["rate"],
                          prompt_len=c["prompt_len"], gen_len=c["batch_gen"],
                          vocab=128, seed=c["seed"], slo_mix=1.0,
                          slo_names=("batch", "batch"))
    for r in batch:
        r.max_new_tokens = max(r.max_new_tokens, c["batch_gen"])
    lat = poisson_trace(c["n_latency"], rate=c["rate"] / 4,
                        prompt_len=c["prompt_len"], gen_len=c["latency_gen"],
                        vocab=128, seed=c["seed"] + 1, slo_mix=1.0,
                        slo_names=("latency", "latency"))
    offset = 2 + max(r.arrival for r in batch)
    for r in lat:
        r.rid += c["n_batch"]
        r.arrival += offset
        r.max_new_tokens = min(r.max_new_tokens, c["latency_gen"])
    return batch + lat


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_bench_serving_preempt_counts(mode):
    """``benchmarks/paging.py:run_preempt`` through the port: steps,
    preemptions, resumes and per-class counts with and without
    preempt-and-swap, the victims' tokens bitwise their un-preempted run,
    and the paged preempt run's telemetry summary."""
    want = _committed("serving_preempt")
    c = want["config"]
    rec = want[mode]
    model = _micro(c["n"])
    max_total = c["prompt_len"] * 2 + 4 * c["batch_gen"] + 1
    trace = _two_class_trace(c)

    def build(preempt, tracer=None):
        serving = ServingConfig(paged=mode == "paged",
                                page_size=c["page_size"], policy="slo",
                                preempt=preempt)
        m = model.with_config(dataclasses.replace(model.cfg,
                                                  serving=serving))
        return ContinuousScheduler(Engine(m, batch=c["batch"],
                                          max_len=max_total), tracer=tracer)

    tracer = Tracer() if mode == "paged" else None
    for key, sched in (("no_preempt", build(False)),
                       ("preempt", build(True, tracer))):
        stats = sched.run(_fresh(trace))
        assert stats.decode_steps == rec[key]["decode_steps"], key
        assert stats.preemptions == rec[key].get("preemptions", 0)
        assert stats.resumes == rec[key].get("resumes", 0)
        for name, pc in rec[key]["per_class"].items():
            for k in ("finished", "preempted", "ttft_p50"):
                assert stats.per_class[name][k] == pc[k], (key, name, k)
    if tracer is not None:
        assert trace_summary(tracer) == rec["preempt"]["telemetry"]

    rng = np.random.default_rng(c["seed"])
    victims = [Request(rid=i, prompt=rng.integers(
        0, 128, c["prompt_len"]).astype(np.int32),
        max_new_tokens=c["batch_gen"], slo="batch")
        for i in range(c["batch"] * c["n"])]
    burst = [Request(rid=100 + i, prompt=rng.integers(
        0, 128, c["prompt_len"]).astype(np.int32),
        max_new_tokens=c["latency_gen"], arrival=3, slo="latency")
        for i in range(2)]
    solo = build(False)
    solo.run(_fresh(victims))
    mixed = build(True)
    assert mixed.run(_fresh(victims + burst)).preemptions > 0
    ref, got = _outputs(solo), _outputs(mixed)
    bitwise = all(got[r.rid] == ref[r.rid] for r in victims)
    assert bitwise is rec["victim_bitwise_identical"] is True


def test_serve_launcher_runs_the_router_on_cpu(capsys):
    router, stats = serve.main(
        ["--device", "cpu", "--smoke", "--workload", "poisson",
         "--replicas", "2", "--router-policy", "least_loaded", "--report",
         "--mux-n", "2", "--gen", "4", "--num-requests", "6"])
    out = capsys.readouterr().out
    assert "[serve] router: 6 requests over 2 replicas" in out
    assert "[serve] fleet:" in out and "[serve]   replica 1:" in out
    assert "[serve] ttft:" in out and "FAIL" not in out
    assert stats.finished == 6 and len(router.replicas) == 2
    assert all(s.engine.model is router.replicas[0].engine.model
               for s in router.replicas)

"""The plain reference against the port's plain path at a tiny size: the
same weights and inputs give the same demuxed states and losses."""
import pytest
import torch

from perfbench import harness, port, traffic, weights
from perfbench.reference.model import Reference, param_specs


@pytest.mark.parametrize("cell", ["tmux-cls", "qwen-score"])
def test_reference_matches_the_port(tiny_bench, cell):
    spec = harness.cell(cell)
    cfg, tr = harness.config(spec["config"]), harness.traffic(spec["traffic"])
    task = {"task": tr["task"], "n_classes": tr.get("n_classes", 0)}
    w = weights.make(param_specs(cfg["model"], cfg["mux"], task), 3, "cpu",
                     torch.float32)
    state, step = port.eval_state(port.model_config(cfg), task, w,
                                  use_flash=False)
    batch = traffic.offline_batches(tr, cfg, 3, "cpu")[0]
    ref = Reference(cfg, w)
    with torch.inference_mode():
        got = state["model"](batch["tokens"])["demuxed"]
        want = ref.demuxed(batch["tokens"])
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        metrics = step(state, {k: v for k, v in batch.items()
                               if k != "index"}, None,
                       retr_index=batch["index"])
        t, tc, r, rc = ref.losses(want, batch["tokens"], task,
                                  labels=batch.get("labels"),
                                  index=batch["index"])
    assert float(metrics["task_loss"]) == pytest.approx(t / tc, rel=1e-5)
    assert float(metrics["retr_loss"]) == pytest.approx(r / rc, rel=1e-5)


def test_fp8_control_rounds_the_products():
    """Under ``fp8`` every product's operands are rounded: a product of
    values e4m3 cannot hold differs from float32, one it can does not."""
    cfg = {"model": {"d_model": 4, "n_heads": 1}, "mux": {}}
    a = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    b = torch.eye(4)
    ref8 = Reference(cfg, {}, "fp8")
    assert torch.equal(ref8.matmul(a, b), a)
    c = torch.tensor([[1.0, 1.01, 1.02, 448.0]])
    assert not torch.equal(ref8.matmul(c, b), c)
    assert torch.equal(Reference(cfg, {}).matmul(c, b), c)

"""The check fails what it must: the float8 control in the program's
place, and the timed path broken underneath (half the batch left out and
the mean taken over the rest; an answer altered where it is produced;
for serving, half the lanes left out of the mixed stream, and a served
token altered where it is sampled), each comes out not correct under the
cells' own limits."""
import pytest
import torch

from perfbench import harness

CELLS = ["tmux-cls", "qwen-score"]


def driver(cell, seed=9):
    spec = harness.workload(cell)
    return harness.load("drivers", spec["driver"]).Driver(
        spec, harness.config(spec["config"]),
        harness.traffic(spec["traffic"]), seed, "cpu")


@pytest.mark.parametrize("cell", CELLS + ["qwen-serve"])
def test_fp8_control_is_not_correct(tiny_bench, cell):
    d = driver(cell)
    items, _ = d.window(1.5 if cell == "qwen-serve" else 0.2)
    assert d.check(items)["correct"] is True
    check = d.control("fp8")
    assert check["correct"] is False
    assert any(value > limit for _, value, limit in check["rows"])


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_is_not_correct(tiny_bench, cell, monkeypatch):
    from repro_torch.training.trainer import Trainer
    loss_fn = Trainer.loss_fn

    def half(state, batch, rng, cfg, tcfg, *, retr_index=None, **kw):
        b = batch["tokens"].shape[0] // 2
        return loss_fn(state, {k: v[:b] for k, v in batch.items()}, rng,
                       cfg, tcfg, retr_index=retr_index[:b], **kw)

    monkeypatch.setattr(Trainer, "loss_fn", staticmethod(half))
    result = harness.run_cell(cell, 9, 0.2, False, device="cpu")
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_swapped_lanes_are_not_correct(tiny_bench, cell, monkeypatch):
    from repro_torch.models.backbone import Backbone
    forward = Backbone.forward

    def swapped(self, *args, **kw):
        out = forward(self, *args, **kw)
        order = torch.arange(out["demuxed"].shape[1])
        order[:2] = torch.tensor([1, 0])
        out["demuxed"] = out["demuxed"][:, order]
        out["logits"] = out["logits"][:, order]
        return out

    monkeypatch.setattr(Backbone, "forward", swapped)
    result = harness.run_cell(cell, 9, 0.2, False, device="cpu")
    assert result["correct"] is False
    assert result["compared"]["demux_gap"]["value"] > \
        result["compared"]["demux_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda_card, cell):
    """The full cell, briefly, on the card (run there by
    ``python -m pytest perfbench/tests -m cuda``)."""
    harness.prepare_env()
    result = harness.run_cell(cell, 2 ** 31 + 3, 2.0, False)
    assert result["correct"] is True and result["device"]["platform"] == \
        "gpu"


def test_serve_half_the_lanes_is_not_correct(tiny_bench, monkeypatch):
    from repro_torch.serving.engine import Engine
    step = Engine.step

    def half(self, state, tokens, lane_mask=None, **kw):
        mask = lane_mask.copy()
        mask[:, mask.shape[1] // 2:] = 0.0
        return step(self, state, tokens, lane_mask=mask, **kw)

    monkeypatch.setattr(Engine, "step", half)
    result = harness.run_cell("qwen-serve", 9, 1.5, False, device="cpu")
    assert result["correct"] is False


def test_serve_altered_token_is_not_correct(tiny_bench, monkeypatch):
    from repro_torch.serving.policies import LaneSampling
    select = LaneSampling.select

    def altered(self, req, logits):
        tok = select(self, req, logits)
        return (tok + 1) % logits.shape[-1] if len(req.output) == 1 else tok

    monkeypatch.setattr(LaneSampling, "select", altered)
    result = harness.run_cell("qwen-serve", 9, 1.5, False, device="cpu")
    assert result["correct"] is False

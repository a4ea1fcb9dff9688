"""The trace reduction on made-up events: busy time is the union of the
device intervals, idle gaps are named by the innermost host op spanning
their middle."""
import torch

from perfbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._v = (name, dev, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_reduce():
    events = [
        Ev("bench.step", CPU, 0, 100), Ev("aten::mm", CPU, 10, 20),
        Ev("aten::item", CPU, 60, 40),
        Ev("gemm", CUDA, 20, 30), Ev("gemm", CUDA, 40, 20),   # 20..60
        Ev("copy", CUDA, 80, 10),                             # 80..90
        Ev("bench.step", CUDA, 20, 70, annotation=True),      # not a kernel
    ]
    seg = trace.reduce(events, 1e-7, 2, {"index_embed_demux": 2})
    assert seg.busy_s == 50e-9 and seg.device_events == 3
    assert seg.kernel_s == {"gemm": 50e-9, "copy": 10e-9}
    assert seg.device_s(r"^gem") == 50e-9
    # the one gap 60..90 has its middle at 75, inside aten::item
    assert seg.gaps == [("aten::item", 20e-9)]
    assert seg.device_ops(1) == [["gemm", 50e-9]]
    assert seg.idle_gaps() == [["aten::item", 20e-9]]


def test_gap_between_ops():
    events = [Ev("aten::mm", CPU, 0, 10), Ev("k", CUDA, 0, 5),
              Ev("k", CUDA, 50, 5)]
    seg = trace.reduce(events, 1e-7, 1, {})
    assert seg.gaps == [("host between ops", 45e-9)]

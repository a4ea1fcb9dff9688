"""hadamard_mux_roofline.offline: the bound time of the traced segment's
Hadamard mux calls (``counts.kernels.hadamard_mux`` over the groups'
prefix and tokens) over the device time of its kernel, in percent."""
from perfbench.counts import kernels, peaks

KERNELS = r"\bhadamard_mux_kernel"


def read(run):
    seg, s = run.segment, run.shapes
    calls = seg.launches.get("hadamard_mux", 0) if seg else 0
    device = seg.device_s(KERNELS) if seg else 0.0
    if not calls or device <= 0:
        return None
    flops, nbytes = kernels.hadamard_mux(
        s["groups"], s["n"], s["prefix"] + s["seq_len"], s["d_model"])
    return 100.0 * calls * peaks.bound_s(flops, nbytes, s["dtype"]) / device

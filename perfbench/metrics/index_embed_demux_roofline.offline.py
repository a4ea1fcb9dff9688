"""index_embed_demux_roofline.offline: the bound time of the traced
segment's index-embed demux calls (``counts.kernels.index_embed_demux``
at the step's shapes, times the program's launch count) over the device
time of its kernels, in percent."""
from perfbench.counts import kernels, peaks

KERNELS = r"\bdemux_(gemm|lane|cluster)_kernel"


def read(run):
    seg, s = run.segment, run.shapes
    calls = seg.launches.get("index_embed_demux", 0) if seg else 0
    device = seg.device_s(KERNELS) if seg else 0.0
    if not calls or device <= 0:
        return None
    flops, nbytes = kernels.index_embed_demux(
        s["groups"], s["n"], s["seq_len"], s["d_model"], s["demux_hidden"])
    return 100.0 * calls * peaks.bound_s(flops, nbytes, s["dtype"]) / device

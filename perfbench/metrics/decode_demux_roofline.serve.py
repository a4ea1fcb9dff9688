"""decode_demux_roofline.serve: the bound time of the traced segment's
decode-demux launches (``counts.kernels.index_embed_demux`` at the step's
slots x lanes x chunk rows) over the device time of its kernels, in
percent."""
from perfbench.counts import kernels, peaks

KERNELS = r"\bdecode_(gemm|lane)_kernel|\bdemux_cluster_kernel"


def read(run):
    seg, s = run.segment, run.shapes
    calls = seg.launches.get("decode_demux", 0) if seg else 0
    device = seg.device_s(KERNELS) if seg else 0.0
    if not calls or device <= 0:
        return None
    flops, nbytes = kernels.index_embed_demux(
        s["slots"], s["n"], s["chunk"], s["d_model"], s["demux_hidden"])
    return 100.0 * calls * peaks.bound_s(flops, nbytes, s["dtype"]) / device

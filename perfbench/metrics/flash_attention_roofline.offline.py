"""flash_attention_roofline.offline: the bound time of the traced
segment's flash-attention calls (``counts.kernels.flash_attention``, one
per layer over the groups' prefix and tokens, causal) over the device
time of its kernels, in percent."""
from perfbench.counts import kernels, peaks

KERNELS = r"\bflash_attention_\w*kernel"


def read(run):
    seg, s = run.segment, run.shapes
    calls = seg.launches.get("flash_attention", 0) if seg else 0
    device = seg.device_s(KERNELS) if seg else 0.0
    if not calls or device <= 0:
        return None
    rows = s["prefix"] + s["seq_len"]
    flops, nbytes = kernels.flash_attention(
        s["groups"], rows, rows, s["n_heads"], s["head_dim"], s["causal"])
    return 100.0 * calls * peaks.bound_s(flops, nbytes, s["dtype"]) / device

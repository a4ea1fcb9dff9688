"""paged_decode_attention_roofline.serve: the bound time of the traced
segment's paged-attention launches (``counts.kernels.paged_decode_attention``
over the positions each live slot had mapped in that step; every layer of
a step alike) over the device time of its kernel, in percent."""
from perfbench.counts import kernels, peaks

KERNELS = r"\bpaged_split_kernel"


def read(run):
    seg, s = run.segment, run.shapes
    steps = run.driver.traced_items() if seg else []
    calls = seg.launches.get("paged_decode_attention", 0) if seg else 0
    device = seg.device_s(KERNELS) if seg else 0.0
    if not steps or not calls or device <= 0:
        return None
    tape = run.driver.tape
    bound = sum(peaks.bound_s(*kernels.paged_decode_attention(
        tape[it["tape"]]["rows_keys"], s["n_heads"], s["n_kv_heads"],
        s["head_dim"], s["chunk"], s["slots"]), s["dtype"]) for it in steps)
    return 100.0 * bound * calls / len(steps) / device

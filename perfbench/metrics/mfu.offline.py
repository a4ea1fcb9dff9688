"""mfu.offline: the FLOPs that the window's results read
(``counts.step.offline_step`` per batch) over the window's seconds and the
card's bf16 peak, in percent."""
from perfbench.counts import peaks, step


def read(run):
    if run.window_s <= 0 or not run.items:
        return None
    flops = step.offline_step(run.shapes) * len(run.items)
    return 100.0 * flops / (run.window_s * peaks.PEAK_FLOPS[
        run.shapes["dtype"]])

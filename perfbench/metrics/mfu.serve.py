"""mfu.serve: the FLOPs the window's steps read (``counts.step.serve_step``:
each live slot's advanced rows through the backbone, the demux and logits
of the tokens emitted) over the window's seconds and the card's bf16
peak, in percent."""
from perfbench.counts import peaks, step


def read(run):
    if run.window_s <= 0 or not run.items:
        return None
    tape = run.driver.tape
    flops = sum(step.serve_step(run.shapes, tape[it["tape"]]["rows_keys"],
                                it["tokens"]) for it in run.items)
    return 100.0 * flops / (run.window_s * peaks.PEAK_FLOPS[
        run.shapes["dtype"]])

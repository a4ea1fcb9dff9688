"""launches_per_batch.offline: kernels, copies and fills the card ran per
batch in the traced segment (the profiler's device events)."""


def read(run):
    seg = run.segment
    if seg is None or not seg.items or not seg.device_events:
        return None
    return seg.device_events / seg.items

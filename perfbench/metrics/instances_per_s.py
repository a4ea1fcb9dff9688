"""instances_per_s: instances whose results reached the host in the window,
over the window's seconds (host clock, from its start to the end of its
last answer)."""


def read(run):
    done = sum(it["instances"] for it in run.items)
    return done / run.window_s if run.window_s > 0 else None

"""batch_p95_ms: the 95th percentile of every batch's time in the window,
from the call until its metrics are on the host (host clock)."""
import statistics


def read(run):
    times = [(it["end"] - it["start"]) * 1e3 for it in run.items]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]

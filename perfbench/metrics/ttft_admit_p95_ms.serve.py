"""ttft_admit_p95_ms.serve: the 95th percentile, over requests whose first
token came in the window, of the host ms from the start of the step that
admitted the request to the end of the step that emitted its first
token."""
import statistics


def read(run):
    times = getattr(run.driver, "ttft_ms", [])
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]

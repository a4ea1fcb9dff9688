"""itl_p95_ms.serve: the 95th percentile of the host ms between a lane's
consecutive tokens, over the gaps that ended in the window."""
import statistics


def read(run):
    gaps = getattr(run.driver, "itl_ms", [])
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94]

"""verify_p95_ms: the 95th percentile of every request's latency in the
window, from its start to its verdict on the host after the device has
synchronised (statistics.quantiles, inclusive)."""

import statistics


def read(w):
    if len(w.latencies_s) < 2:
        return None
    return statistics.quantiles(w.latencies_s, n=100, method="inclusive")[94] * 1e3

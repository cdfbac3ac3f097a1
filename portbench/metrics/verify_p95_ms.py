"""verify_p95_ms.host: the 95th percentile of the traced requests'
latencies on the host clock (statistics.quantiles, inclusive), each from
its start to its verdict after the device has synchronised.  The
profiler's overhead is in every one of them."""

import statistics


def read(td):
    if len(td.latencies_s) < 2:
        return None
    return statistics.quantiles(td.latencies_s, n=100, method="inclusive")[94] * 1e3

"""90th percentile of the window's job latencies, start to answer on the
host, in ms (``statistics.quantiles``, inclusive method)."""

import statistics


def read(ctx):
    lat = [j.latency_s * 1e3 for j in ctx.jobs]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]

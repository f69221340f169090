"""The 90th percentile of every window view's latency, call to numpy
result (host clock), in ms."""

import statistics


def read(obs):
    lat = obs.get("latencies") if obs.get("kind") == "views" else None
    if not lat or len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]

"""serve_p95_ms: the 95th percentile (nearest rank) of every batch's
latency in the window, from its hand-off to ``predict_iter`` to its
results on the host."""

import math


def read(rec):
    lat = rec.get("latencies_ms")
    if rec.get("kind") != "serve" or not lat:
        return None
    return sorted(lat)[math.ceil(0.95 * len(lat)) - 1]

"""95th percentile of every request's latency in the window, by nearest
rank: the smallest latency that at least 95 % of the requests do not
exceed."""
import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

"""90th percentile of ``queue_wait_s`` (``serving/server.py``: the due time
to the stream's slot admission) over the window's finished requests, in ms."""

import statistics


def read(record):
    waits = [w for w in record["queue_wait_s"] if w is not None]
    if len(waits) < 2:
        return None
    return 1e3 * statistics.quantiles(waits, n=10, method="inclusive")[-1]

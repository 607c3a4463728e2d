"""Mean time between the ends of consecutive ``genvc.fetch`` spans
(``serving/server.py``: one pool tick's results reaching the host) in the
traced region, the serving loop's idle sleeps left out, in ms."""

from perfbench import readers


def read(record):
    ends = record["trace"].span_ends("genvc.fetch")
    if len(ends) < 2:
        return None
    busy = (ends[-1] - ends[0]) / 1e6 - readers.idle_within(record)
    return 1e3 * busy / (len(ends) - 1)

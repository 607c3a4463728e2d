"""Host time of the ``genvc.loader.wait`` spans per traced training step
(``data/loader.py`` ``BatchLoader``: from asking for the next batch until it
is in hand, without the copy to the card), in ms. The spans are the
profiler's copies of the program's ``tracing`` spans. None on a program
without them."""

NAME = "genvc.loader.wait"


def read(record):
    tr = record["trace"]
    if not record["steps"] or not any(n == NAME for n, _, _ in tr.spans):
        return None
    return 1e3 * tr.span_s(NAME) / len(record["steps"])

"""Share of the traced steps' device idle time that falls inside the
``genvc.loader.wait`` spans (``data/loader.py``: the host waiting for a
batch), in %. Idle time is the traced region, from its first host span or
kernel to its last, less the union of the kernels; the spans are the
profiler's copies of the program's ``tracing`` spans, on the kernels' clock.
None on a program without them."""

NAME = "genvc.loader.wait"


def read(record):
    tr = record["trace"]
    waits = sorted((s, e) for n, s, e in tr.spans if n == NAME)
    if not waits or not tr.kernels:
        return None
    busy = []
    for _, s, e in tr.kernels:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    lo = min(tr.spans[0][1], busy[0][0])
    hi = max(max(e for _, _, e in tr.spans), busy[-1][1])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    inside = sum(max(0.0, min(b, we) - max(a, ws)) for a, b in idle for ws, we in waits)
    return 100.0 * inside / total if total > 0 else None

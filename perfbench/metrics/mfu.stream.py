"""Model FLOPs of the traced calls (every family at the request's true
lengths, each at the peak of the type it runs in) over their wall time: the
share of the card's peak the whole call reaches, in %."""

from perfbench import readers


def read(record):
    wall = record["trace"].wall_s
    return 100.0 * readers.stream_peak_seconds(record) / wall if wall > 0 else None

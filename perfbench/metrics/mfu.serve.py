"""Model FLOPs of the traced serving region (speaker latents at submission,
admissions, every tick's decode steps and windows of occupied rows, each at
the peak of its type) over its wall time, in %."""

from perfbench import readers


def read(record):
    wall = record["trace"].wall_s
    return 100.0 * readers.serve_peak_seconds(record) / wall if wall > 0 else None

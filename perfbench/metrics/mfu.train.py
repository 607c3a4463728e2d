"""Model FLOPs of the traced training steps (GPT forward and backward, the
frozen tokenizers and the Perceiver, each at the peak of its type) over
their wall time, in %."""

from perfbench import readers


def read(record):
    wall = record["trace"].wall_s
    return 100.0 * readers.train_peak_seconds(record) / wall if wall > 0 else None

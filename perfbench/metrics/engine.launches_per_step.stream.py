"""Kernel launches the host made in the traced calls per decode step
(``decode/engine.py`` holds most of them)."""

from perfbench import readers


def read(record):
    steps = readers.stream_decode_steps(record)
    return record["trace"].launches / steps if steps else None

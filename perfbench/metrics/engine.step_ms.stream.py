"""Host time of the ``genvc.decode`` spans per decode step of the traced
calls (``decode/engine.py``), in ms. Each span ends by reading the window's
tokens back, so it holds the device's time too."""

from perfbench import readers


def read(record):
    steps = readers.stream_decode_steps(record)
    return 1e3 * record["trace"].span_s("genvc.decode") / steps if steps else None

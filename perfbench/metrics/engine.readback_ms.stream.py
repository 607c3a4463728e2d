"""Host time of the ``genvc.decode.readback`` spans per decode step of the
traced calls (``inference/pipeline.py``: the blocking read of a window's
tokens, so the device's time left after the host's enqueue), in ms. With
``engine.enqueue_ms.stream`` it makes up ``engine.step_ms.stream``. The
spans are the profiler's copies of the program's ``tracing`` spans. None on
a program without them."""

from perfbench import readers

NAME = "genvc.decode.readback"


def read(record):
    tr = record["trace"]
    steps = readers.stream_decode_steps(record)
    if not steps or not any(n == NAME for n, _, _ in tr.spans):
        return None
    return 1e3 * tr.span_s(NAME) / steps

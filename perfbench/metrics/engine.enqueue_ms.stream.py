"""Host time of the ``genvc.decode.enqueue`` spans per decode step of the
traced calls (``decode/engine.py``: ``decode_chunk`` issuing a window's
steps, and the latents' join), in ms: the host's share of ``genvc.decode``
that a CUDA graph of the step would shrink. The spans are the profiler's
copies of the program's ``tracing`` spans, so they carry the profiler's
cost, as ``engine.step_ms.stream`` does. None on a program without them."""

from perfbench import readers

NAME = "genvc.decode.enqueue"


def read(record):
    tr = record["trace"]
    steps = readers.stream_decode_steps(record)
    if not steps or not any(n == NAME for n, _, _ in tr.spans):
        return None
    return 1e3 * tr.span_s(NAME) / steps

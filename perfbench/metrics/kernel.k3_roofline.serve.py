"""K3 (``ops/decode_attention.py``, the per-row decode attention with its
cache write): the least time of its calls in the traced region at the pool's
shapes over the device time of its two kernels, in %."""

from perfbench import readers


def read(record):
    dev = record["trace"].device_s("decode_split_logits", "decode_split_pv")
    return 100.0 * readers.serve_k3_bound_s(record) / dev if dev > 0 else None

"""K1 (``ops/decode_attention.py``, the cached decode attention): the least
time of its calls in the traced calls (bytes of the keys and values written
so far, query, bias and output at 3.35 TB/s) over the device time of its two
kernels, ``decode_split_logits`` and ``decode_split_pv``, in %."""

from perfbench import readers


def read(record):
    dev = record["trace"].device_s("decode_split_logits", "decode_split_pv")
    return 100.0 * readers.stream_k1_bound_s(record) / dev if dev > 0 else None

"""K4-K6 (``ops/flash_attention.py``: the flash-attention forward and the
two backward kernels): the least time of the traced steps' calls over the
device time of ``flash_fwd*`` and ``flash_bwd*`` kernels, in %."""

from perfbench import readers


def read(record):
    dev = record["trace"].device_s("flash_fwd", "flash_bwd")
    return 100.0 * readers.train_flash_bound_s(record) / dev if dev > 0 else None

"""The absorbed latent attention (``ops/mla.py``, ``csrc/mla_decode.cu``):
the least time of its calls in the traced group (each row's latent cache
at its true length read once, the new row written, queries and outputs, at
3.35 TB/s) over the device time of its two launches, ``mla_split`` and
``mla_combine``, in %. None on a program without the kernel."""

from perfbench import flops_moonlight


def read(record):
    dev = record["trace"].device_s("mla_split", "mla_combine")
    return 100.0 * flops_moonlight.mla_bound_s(record) / dev if dev > 0 else None

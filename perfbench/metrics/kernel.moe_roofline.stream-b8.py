"""The routed experts (``ops/moe.py``, ``csrc/moe_experts.cu``): the least
time of their calls in the traced group (the weights of every expert the
routing chose, once a call, counted by the program's ``moe.experts_touched``,
plus each row's input, output, indices and weights, at 3.35 TB/s) over the
device time of the kernel's three launches, in %. None on a program without
the counter or the kernel."""

from perfbench import flops_moonlight


def read(record):
    bound = flops_moonlight.moe_bound_s(record)
    dev = record["trace"].device_s("moe_gate_up", "moe_down", "moe_combine")
    return 100.0 * bound / dev if bound and dev > 0 else None

"""Model FLOPs of the traced group (every family at the rows' true lengths,
6 routed and 2 shared experts a token, each at the peak of the type it runs
in) over the group's wall time: the share of the card's peak the whole call
reaches, in %."""

from perfbench import flops_moonlight


def read(record):
    wall = record["trace"].wall_s
    return 100.0 * flops_moonlight.group_peak_seconds(record) / wall if wall > 0 else None

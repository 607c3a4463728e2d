"""Share of the traced serving region's wall time in which no kernel ran,
in %."""


def read(record):
    tr = record["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)

"""Share of the traced calls' wall time spent in the ``genvc.vocode`` spans
(``inference/pipeline.py``: x4 interpolation, HiFi-GAN, crossfade), in %."""


def read(record):
    wall = sum(c["end"] - c["start"] for c in record["calls"])
    return 100.0 * record["trace"].span_s("genvc.vocode") / wall if wall > 0 else None

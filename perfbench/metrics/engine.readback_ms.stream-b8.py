"""``engine.readback_ms.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): host time of its ``genvc.decode.readback`` spans (the blocking read
of a window's tokens and end flags) per lockstep decode step, in ms. None
on a program without the spans."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "engine.readback_ms.stream")

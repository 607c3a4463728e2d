"""``device.idle_share.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): the share of its wall time in which no kernel ran, in %."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "device.idle_share.stream")

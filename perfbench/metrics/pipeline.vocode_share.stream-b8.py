"""``pipeline.vocode_share.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): the share of the group's wall time spent in its ``genvc.vocode``
spans (the rows' window accounting, x4 interpolation, the batched HiFi-GAN
windows, tails and crossfades), in %."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "pipeline.vocode_share.stream")

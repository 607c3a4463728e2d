"""``engine.launches_per_step.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): kernel launches the host made per lockstep decode step
(``decode/engine.py`` holds most of them)."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "engine.launches_per_step.stream")

"""``engine.step_ms.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): host time of its ``genvc.decode`` spans per lockstep decode step
(``decode/engine.py``), in ms. Each span ends by reading the window's
tokens back, so it holds the device's time too."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "engine.step_ms.stream")

"""``engine.enqueue_ms.stream``'s reading of the traced group of
``synthesize_streaming_batch`` (8 callers in lockstep, recorded as one
call): host time of its ``genvc.decode.enqueue`` spans (``decode_chunk``
issuing a window's steps of the DeepSeek-V3 backbone, and the latents'
join) per lockstep decode step, in ms; profiled host time. None on a
program without the spans."""

import os

from perfbench import manifest

read = manifest.metric_reader(os.path.dirname(manifest.DIR), "engine.enqueue_ms.stream")

"""Share of the traced steps' device busy time spent in kernels under the
``genvc.features`` annotation (``train/gpt_stage.py`` ``prepare_features``:
the frozen f32 tokenizers), in %."""


def read(record):
    tr = record["trace"]
    busy = tr.busy_s()
    return 100.0 * tr.device_s_within("genvc.features") / busy if busy > 0 else None

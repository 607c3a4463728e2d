"""Host time the training loop waited per step for the next batch from
the port's ``BatchLoader`` (``data/loader.py``) and its copy to the card,
over the window's steps, in ms."""


def read(record):
    waits = record["waits"]
    return 1e3 * sum(waits) / len(waits) if waits else None

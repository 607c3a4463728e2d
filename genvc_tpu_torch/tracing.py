"""The port's spans and counters, kept in memory.

``span(name, req=None)`` is a context manager that enters
``torch.profiler.record_function(name)``, so a profiler trace holds every
``genvc.*`` span as before. Only while the recorder is enabled (:func:`enable`)
does a span also record its name, start and end on one monotonic host clock
(``time.perf_counter_ns``), the enclosing span of the same thread (its parent),
the thread and a request id; and :func:`count` add to a named counter. Off is
the default, and off a span costs one flag test beyond ``record_function``.
Nothing is written out: :func:`snapshot` returns what was recorded.

Request ids: the streaming call's index (``synthesize_streaming``), the
training step (the GPT step), the batch's index in its epoch (the loader).
"""

from __future__ import annotations

import itertools
import threading
import time

from torch.profiler import record_function

_on = False
_lock = threading.Lock()
_spans: list[dict] = []
_counters: dict[str, int] = {}
_ids = itertools.count()
_stack = threading.local()


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while the recorder is enabled."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


class span:
    """``with span("genvc.decode", req=i):`` -- a profiler annotation, and
    while the recorder is enabled one recorded span."""

    __slots__ = ("_rf", "_rec", "name", "req")

    def __init__(self, name: str, req=None):
        self.name = name
        self.req = req
        self._rf = record_function(name)
        self._rec = None

    def __enter__(self):
        self._rf.__enter__()
        if _on:
            open_ = getattr(_stack, "open", None)
            if open_ is None:
                open_ = _stack.open = []
            rec = {"id": next(_ids), "name": self.name, "req": self.req,
                   "thread": threading.get_native_id(),
                   "parent": open_[-1]["id"] if open_ else None,
                   "start_ns": time.perf_counter_ns(), "end_ns": None}
            open_.append(rec)
            with _lock:
                _spans.append(rec)
            self._rec = rec
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            rec["end_ns"] = time.perf_counter_ns()
            _stack.open.pop()
            self._rec = None
        self._rf.__exit__(*exc)


def snapshot() -> dict:
    """``{"spans": [...], "counters": {...}}``: the closed spans in order of
    start, each a dict of ``id``, ``name``, ``req``, ``thread`` (native id),
    ``parent`` (the enclosing span's id on the same thread, or None; it may
    have opened before the last :func:`reset`), ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``) and ``self_ns`` (the duration less the
    children's), and a copy of the counters."""
    with _lock:
        spans = [dict(s) for s in _spans if s["end_ns"] is not None]
        counters = dict(_counters)
    children = {}
    for s in spans:
        if s["parent"] is not None:
            children[s["parent"]] = children.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    for s in spans:
        s["self_ns"] = s["end_ns"] - s["start_ns"] - children.get(s["id"], 0)
    spans.sort(key=lambda s: s["start_ns"])
    return {"spans": spans, "counters": counters}


"""Traffic from a mix's parameters and a seed: one generator for every mix.

A mix file (``perfbench/traffic/<name>.json``) gives the length
distributions of sources and references, the arrival process and the number
of requests. Every seed gets the same multiset of sizes and gaps: each is the
distribution's quantile at (i + 0.5) / n, for i < n. The seed shuffles them and
picks each clip's recording and offset, so two seeds do the same work in
another order. A mix with ``order_seed`` keeps one order for every seed (the
seed then picks only the clips): an open loop's tail latency depends on the
order in which long requests arrive.

* ``"arrivals": "closed"``: one caller; the list is run back to back,
  cycling with a new order each pass.
* ``"arrivals": "poisson"``: exponential gaps at ``rate`` requests per
  second. ``burst`` (optional) groups ``size`` requests at one instant with
  the group's gaps summed, the same mean rate.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    src_seconds: float
    ref_seconds: float
    src_which: int
    src_offset: float
    ref_which: int
    ref_offset: float
    at: float = 0.0          # due time from the window's start (open loop)


def _quantiles(d: dict, n: int) -> np.ndarray:
    p = (np.arange(n) + 0.5) / n
    kind = d["dist"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(q)) for q in p])
        x = d["median"] * np.exp(d["sigma"] * z)
    elif kind == "uniform":
        x = d["low"] + (d["high"] - d["low"]) * p
    elif kind == "fixed":
        x = np.full(n, float(d["value"]))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(x, d.get("min", -np.inf), d.get("max", np.inf))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def requests(mix: dict, seed: int, n: int | None = None, rate: float | None = None,
             stream: int = 0) -> list[Request]:
    """``n`` requests (default the mix's ``requests``) of ``mix`` from
    ``seed``. ``stream`` selects an independent shuffle of the same
    multiset (a later pass of a closed loop, or a lead-in)."""
    n = int(mix["requests"] if n is None else n)
    g = rng(seed, stream)
    o = rng(mix["order_seed"], stream) if "order_seed" in mix else g
    src = o.permutation(_quantiles(mix["src_seconds"], n))
    ref = o.permutation(_quantiles(mix["ref_seconds"], n))
    which = g.integers(0, 1 << 16, size=(n, 2))
    offset = g.random((n, 2))
    at = np.zeros(n)
    if mix["arrivals"] == "poisson":
        r = float(mix["rate"] if rate is None else rate)
        gaps = o.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / r)
        size = int(mix.get("burst", {}).get("size", 1))
        groups = [gaps[i: i + size].sum() for i in range(0, n, size)]
        at = np.repeat(np.cumsum(groups), size)[:n]
    elif mix["arrivals"] != "closed":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    return [Request(float(src[i]), float(ref[i]), int(which[i, 0]), float(offset[i, 0]),
                    int(which[i, 1]), float(offset[i, 1]), float(at[i])) for i in range(n)]


def mean_rate(reqs: list[Request]) -> float:
    span = reqs[-1].at - reqs[0].at
    return (len(reqs) - 1) / span if span > 0 else math.inf

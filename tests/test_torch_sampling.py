"""The per-row sampling chain (``process_logits_per_row``) of the port against
the JAX package's on rows with mixed configs (top-k 0 / 1 / 15, top-p 0.85 /
1, several temperatures and penalties): the same tokens kept (finite) and the
kept logits within atol 1e-6 (the same f32 arithmetic; the softmax sums run
in another order). With one shared config it equals the port's scalar chain
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genvc_tpu.ops import sampling as jsamp
from genvc_tpu_torch.ops import sampling as tsamp

V = 1026
ROWS = [  # (repetition_penalty, temperature, top_k, top_p)
    (2.0, 0.85, 15, 0.85), (1.0, 1.0, 0, 1.0), (1.0, 1.0, 1, 1.0),
    (1.3, 0.7, 0, 0.85), (2.0, 1.2, 15, 1.0), (1.0, 0.5, 1, 0.85),
]


def _logits(seed, b):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, V)) * 3).astype(np.float32),
            rng.random((b, V)) < 0.05)


def _params(rows):
    cols = list(zip(*rows))
    return {"repetition_penalty": np.asarray(cols[0], np.float32),
            "temperature": np.asarray(cols[1], np.float32),
            "top_k": np.asarray(cols[2], np.int32), "top_p": np.asarray(cols[3], np.float32)}


def _port(logits, seen, params):
    return tsamp.process_logits_per_row(
        torch.from_numpy(logits), torch.from_numpy(seen),
        **{k: torch.from_numpy(v.astype(np.int64) if k == "top_k" else v)
           for k, v in params.items()}).numpy()


def test_torch_per_row_chain_matches_jax_on_mixed_rows():
    logits, seen = _logits(0, len(ROWS))
    params = _params(ROWS)
    want = np.asarray(jsamp.process_logits_per_row(
        jnp.asarray(logits), jnp.asarray(seen),
        **{k: jnp.asarray(v) for k, v in params.items()}))
    got = _port(logits, seen, params)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-6)
    kept = np.isfinite(got).sum(axis=1)
    assert kept[1] == V and kept[2] == 1 and kept[5] == 1  # identities and greedy
    assert 1 <= kept[0] <= 15 and kept[4] == 15


@pytest.mark.parametrize("row", ROWS)
def test_torch_per_row_chain_equals_scalar_chain(row):
    logits, seen = _logits(1, 4)
    got = _port(logits, seen, _params([row] * 4))
    pen, temp, k, p = row
    want = tsamp.process_logits(torch.from_numpy(logits), torch.from_numpy(seen),
                                repetition_penalty=pen, temperature=temp, top_k=k,
                                top_p=p).numpy()
    np.testing.assert_array_equal(got, want)

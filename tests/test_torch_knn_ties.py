"""The port's plain kNN (rows 1 and 2) on tie-heavy and edge cases, against
the JAX package's Pallas kernels in interpret mode (``knn_graph_pallas``,
``knn_graph_pallas_qk``) and its XLA ``features.knn_graph``, with
``E_idx`` exact.

Exact ties come from coordinates on an integer grid and from duplicated
residues: equal squared distances give equal values on every side, whatever
order each side adds ``eps`` in (the Pallas kernel adds it first, XLA and
the port last), so the lowest key index must win everywhere. Distances are
held to 1e-5, as in ``test_torch_kernels.py``. The cases: masked query rows
(padding), masked keys interleaved with valid ones, ``Lk < k`` and ``Lk =
k``, ``Lk`` not a multiple of 32, B > 1 with different lengths, and query
shards that start mid-structure. The CUDA kernel meets the same cases on the
card (``chip_smoke.py::knn_hard_cases``).
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from na_mpnn_tpu.models.features import knn_graph as jax_knn_graph
from na_mpnn_tpu.ops.knn import knn_graph_pallas, knn_graph_pallas_qk

from na_mpnn_tpu_torch.ops import knn


def _grid(B, L, seed):
    """Coordinates on the integer grid {0..3}^3: many exactly equal
    distances."""
    return np.random.RandomState(seed).randint(0, 4, (B, L, 3)).astype(np.float32)


def _duplicated_walk(B, L, seed):
    """A random walk whose residues come in identical pairs."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randn(B, (L + 1) // 2, 3) * 3.0, axis=1)
    return np.repeat(walk, 2, axis=1)[:, :L].astype(np.float32)


def _lengths_mask(L, lengths, every=0):
    """Valid rows ``:n`` of each structure (the rest masked, as padding),
    and every ``every``-th key masked among them."""
    mask = np.zeros((len(lengths), L), np.float32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    if every:
        mask[:, 1::every] = 0
    return mask


CASES = {
    "grid, masked rows and keys": (_grid(2, 70, 0), _lengths_mask(70, (70, 50), 4), 16),
    "duplicated residues": (_duplicated_walk(1, 64, 1), _lengths_mask(64, (60,)), 32),
    "Lk < k": (_grid(2, 12, 2), _lengths_mask(12, (12, 9)), 16),
    "Lk = k": (_grid(1, 16, 3), _lengths_mask(16, (16,), 5), 16),
    "B=3, lengths 45, 30, 12": (_grid(3, 45, 4), _lengths_mask(45, (45, 30, 12), 6), 32),
    "duplicated, L=100": (_duplicated_walk(2, 100, 5), _lengths_mask(100, (100, 77), 9), 32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_knn_ties_match_pallas_and_xla(case):
    X, mask, k = CASES[case]
    B, L = mask.shape
    D_t, E_t = knn.knn_graph(torch.from_numpy(X), torch.from_numpy(mask), k)
    D_p, E_p = knn_graph_pallas(jnp.asarray(X), jnp.asarray(mask), k=k,
                                interpret=True)
    D_x, E_x = jax_knn_graph(jnp.asarray(X), jnp.asarray(mask), k)
    assert E_t.shape == (B, L, min(k, L)) and E_t.dtype == torch.int64
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_p))
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_x))
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_p), atol=1e-5)
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_x), atol=1e-5)
    # the masked query rows select keys 0..k-1 at distance 0
    rows = mask == 0
    assert (E_t.numpy()[rows] == np.arange(min(k, L))).all()
    assert (D_t.numpy()[rows] == 0).all()


@pytest.mark.parametrize("case,start,n", [
    ("grid, masked rows and keys", 23, 20),
    ("B=3, lengths 45, 30, 12", 10, 25),
    ("duplicated, L=100", 37, 40),
])
def test_knn_qk_ties_match_pallas_and_the_structure_rows(case, start, n):
    """A shard of ``n`` query rows from ``start`` (mid-structure, masked
    rows included) against all the structure's keys."""
    X, mask, k = CASES[case]
    sl = slice(start, start + n)
    Xq, mq = np.ascontiguousarray(X[:, sl]), np.ascontiguousarray(mask[:, sl])
    t = torch.from_numpy
    D, E = knn.knn_graph_qk(t(Xq), t(X), t(mq), t(mask), k)
    D_p, E_p = knn_graph_pallas_qk(jnp.asarray(Xq), jnp.asarray(X),
                                   jnp.asarray(mq), jnp.asarray(mask), k=k,
                                   interpret=True)
    _, E_x = jax_knn_graph(jnp.asarray(X), jnp.asarray(mask), k)
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_p))
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_x)[:, sl])
    np.testing.assert_allclose(D.numpy(), np.asarray(D_p), atol=1e-5)
    D_s, E_s = knn.knn_graph_plain(t(X), t(mask), k)
    np.testing.assert_array_equal(E.numpy(), E_s[:, sl].numpy())
    np.testing.assert_array_equal(D.numpy(), D_s[:, sl].numpy())

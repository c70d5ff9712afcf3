"""The row-sorted edge order behind the message-table backward's table
gradient (``ops/message_kernels.py::table_order``): the CUDA kernel sums
each table row's edge contributions in this order, one warp per row, with
no atomics. The kernel runs only on the card; this file holds the index
glue it is given, on the CPU.

Tolerance: summing the contributions through the order equals
``index_add_`` at float64 to 1e-12 (the same terms, summed in another
order)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

from na_mpnn_tpu_torch.ops import message_kernels as mk

L = 50


def _edges(B, K, Lk, seed):
    rng = np.random.RandomState(seed)
    eidx = torch.from_numpy(rng.randint(0, Lk, B * L * K).astype(np.int64))
    return eidx


@pytest.mark.parametrize("Lk", [L, 3 * L + 7])
@pytest.mark.parametrize("C", [32, 64])
def test_sums_through_the_order_equal_index_add(Lk, C):
    """Lk = L on one device; Lk > L on the graph-parallel route (a shard's
    L rows against the all-gathered structure's Lk rows); C = H or 2H."""
    B, K = 3, 8
    eidx = _edges(B, K, Lk, seed=Lk + C)
    E = eidx.shape[0]
    n_rows = B * Lk
    tab = torch.from_numpy(np.random.RandomState(C).randn(E, C))
    order, offsets = mk.table_order(eidx, K, L, Lk, n_rows)
    assert order.shape == (E,) and offsets.shape == (n_rows + 1,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == E
    got = torch.zeros((n_rows, C), dtype=torch.float64)
    for t in range(n_rows):
        rows = tab[order[offsets[t]:offsets[t + 1]]]
        for r in rows:           # in ascending edge order, as the kernel adds
            got[t] += r
    want = torch.zeros_like(got).index_add_(0, mk.table_rows(eidx, K, L, Lk), tab)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("Lk", [L, 2 * L])
def test_each_row_lists_its_own_edges_in_ascending_order(Lk):
    B, K = 2, 16
    eidx = _edges(B, K, Lk, seed=5)
    keys = mk.table_rows(eidx, K, L, Lk)
    order, offsets = mk.table_order(eidx, K, L, Lk, B * Lk)
    assert torch.equal(torch.sort(order).values, torch.arange(eidx.shape[0]))
    for t in range(B * Lk):
        seg = order[offsets[t]:offsets[t + 1]]
        assert torch.all(keys[seg] == t)
        assert torch.all(seg[1:] > seg[:-1])
    # node n = e // K lies in structure n // L, whose rows start at b * Lk
    node = torch.arange(eidx.shape[0]) // K
    assert torch.equal(keys, (node // L) * Lk + eidx)


def test_the_order_rebuilds_the_plain_table_gradient():
    """The plain backward's table gradient, rebuilt from per-edge
    contributions summed through the order (the kernel's route), in the
    decoder mode (C = 2H), at float64."""
    B, K, H = 2, 8, 32
    N = B * L
    rng = np.random.RandomState(11)
    f = lambda *s: torch.from_numpy(rng.randn(*s) * 0.5)  # noqa: E731
    eidx = torch.from_numpy(rng.randint(0, L, N * K).astype(np.int64))
    m1d = torch.from_numpy((rng.rand(N * K) > 0.2).astype(np.float64))
    mbw = m1d * torch.from_numpy((rng.rand(N * K) > 0.5).astype(np.float64))
    args = ("dec", f(N, H), f(N * K, H), f(N * K, H), eidx, m1d, mbw,
            f(H, H) / 8, f(H, H) / 8, f(H), f(H, H) / 8, f(H), f(H, H) / 8, f(H),
            f(N, H))
    g_table = mk.message_table_bwd_plain(*args, K=K, L=L)[2]
    # g_x from the plain chain, as the kernel's tile pass produces it
    x, w2, b2, w3, g = args[3], args[10], args[11], args[12], args[14]
    y = torch.nn.functional.gelu(x) @ w2 + b2
    g_m = g.repeat_interleave(K, dim=0) / 30.0
    g_x = ((g_m @ w3.T) * mk.gelu_grad(y)) @ w2.T * mk.gelu_grad(x)
    tab = torch.cat([mbw[:, None] * g_x, m1d[:, None] * g_x], dim=1)
    order, offsets = mk.table_order(eidx, K, L, L, N)
    got = torch.stack([tab[order[offsets[t]:offsets[t + 1]]].sum(0)
                       for t in range(N)])
    np.testing.assert_allclose(got.numpy(), g_table.numpy(), rtol=0, atol=1e-12)

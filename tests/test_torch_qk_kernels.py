"""The kernel modules of the port's multi-device slice on the CPU (their plain
versions and autograd Functions) against the JAX package: the query/key kNN
(row 2), the query/key entry of the classed RBF (row 3), the dense RBF
projection and its weight gradient (rows 5 and 6), and the message table
with a key length ``Lk != L`` (rows 9 and 10).

Tolerances: kNN indices exact. RBF forwards at fp32 to 5e-6 relative (5184
products per output, summed in another order than the Pallas kernel's);
the dense weight gradient to 5e-5 of its max at fp32 (a sum over all edges
as well); the float64 comparisons, of one function written twice, to
1e-10."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models.features import all_pair_rbf as jax_all_pair_rbf
from na_mpnn_tpu.ops.knn import knn_graph_pallas_qk
from na_mpnn_tpu.ops.rbf_classed import rbf_edge_features_classed_qk as jax_rbf_qk
from na_mpnn_tpu.ops.rbf_edge import (EDGE_TILE, rbf_edge_embed_dw,
                                      rbf_edge_features as jax_rbf_dense,
                                      rbf_weight_permutation)

from na_mpnn_tpu_torch.models.modules import gelu
from na_mpnn_tpu_torch.ops import knn, message_kernels as mk, rbf_classed, rbf_edge


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


@pytest.mark.parametrize("frac,start,masked", [(4, 16, True), (2, 0, False),
                                               (2, 32, True)])
def test_knn_qk_matches_pallas_and_the_structure_rows(frac, start, masked):
    rng = np.random.RandomState(frac + start)
    B, Lk, k = 2, 64, 16
    Lq = Lk // frac
    X = np.cumsum(rng.randn(B, Lk, 3) * 3.0, axis=1).astype(np.float32)
    mask = np.ones((B, Lk), np.float32)
    if masked:
        mask[0, 10:25] = 0
        mask[1, -7:] = 0
    sl = slice(start, start + Lq)
    Xq, mq = np.ascontiguousarray(X[:, sl]), np.ascontiguousarray(mask[:, sl])
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    D, E = knn.knn_graph_qk(t(Xq), t(X), t(mq), t(mask), k)
    D_p, E_p = knn_graph_pallas_qk(jnp.asarray(Xq), jnp.asarray(X),
                                   jnp.asarray(mq), jnp.asarray(mask), k=k,
                                   interpret=True)
    assert E.shape == (B, Lq, k) and E.dtype == torch.int64
    np.testing.assert_array_equal(E.numpy(), np.asarray(E_p))
    np.testing.assert_allclose(D.numpy(), np.asarray(D_p), atol=1e-5)
    D_s, E_s = knn.knn_graph_plain(t(X), t(mask), k)
    np.testing.assert_array_equal(E.numpy(), E_s[:, sl].numpy())
    np.testing.assert_array_equal(D.numpy(), D_s[:, sl].numpy())
    # k larger than the keys: k = Lk
    assert knn.knn_graph_qk_plain(t(Xq), t(X[:, :8]), t(mq), t(mask[:, :8]),
                                  k)[1].shape == (B, Lq, 8)


@pytest.fixture
def rbf_case():
    """Mixed-class structure (protein rows, NA rows, empty rows, one residue
    with atoms of both blocks) of 40 key rows; queries are rows 8..28;
    neighbours are key indices; a random weight and cotangent."""
    rng = np.random.RandomState(0)
    B, L, K, A, R, H = 2, 40, 8, 18, 16, 32
    X = rng.randn(B, L, A, 3).astype(np.float32) * 5
    Xm = np.zeros((B, L, A), np.float32)
    Xm[:, :20, [0, 1, 2, 3, 16]] = 1
    Xm[:, 20:, 4:16] = 1
    Xm[:, 20:, 17] = 1
    Xm[:, 38:] = 0
    Xm[0, 5, 4] = 1
    Xm[1, 12, 2] = 0
    sl = slice(8, 28)
    E_idx = rng.randint(0, L, (B, 20, K)).astype(np.int64)
    W = rng.randn(A * A * R, H).astype(np.float32) * 0.01
    G = rng.randn(B, 20, K, H).astype(np.float32)
    return X, Xm, sl, E_idx, W, G


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [o.to(dtype) if dtype is not None and o.is_floating_point() else o
            for o in out]


def test_rbf_classed_qk_matches_pallas(rbf_case):
    X, Xm, sl, E_idx, W, G = rbf_case
    Xq, Mq, Xt, Mt, Et, Wt = _t(X[:, sl], Xm[:, sl], X, Xm, E_idx, W)
    out = rbf_classed.rbf_edge_features_classed_qk(Xq, Mq, Xt, Mt, Et, Wt)
    ref = jax_rbf_qk(jnp.asarray(X[:, sl]), jnp.asarray(Xm[:, sl]),
                     jnp.asarray(X), jnp.asarray(Xm),
                     jnp.asarray(E_idx.astype(np.int32)), jnp.asarray(W),
                     interpret=True)
    assert out.shape == (2, 20, 8, 32)
    assert _rel(out.numpy(), ref) < 5e-6


def test_rbf_classed_qk_weight_gradient_float64(rbf_case):
    """The query/key Function's weight gradient (row 4 on query/key
    operands; its plain version on the CPU) equals autograd of the dense
    form, and coordinates get none."""
    X, Xm, sl, E_idx, W, G = rbf_case
    Xq, Mq, Xt, Mt, Et, Wt, Gt = _t(X[:, sl], Xm[:, sl], X, Xm, E_idx, W, G,
                                    dtype=torch.float64)
    Wr = Wt.clone().requires_grad_(True)
    ref, = torch.autograd.grad(
        rbf_edge.rbf_edge_features_plain(Xq, Mq, Et, Wr, Xt, Mt), Wr, Gt)
    Xr = Xq.clone().requires_grad_(True)
    got, gx = torch.autograd.grad(rbf_classed.rbf_edge_features_classed_qk(
        Xr, Mq, Xt, Mt, Et, Wr), (Wr, Xr), Gt, allow_unused=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10, rtol=0)
    assert gx is None


def test_rbf_dense_matches_pallas_and_all_pair_rbf(rbf_case):
    X, Xm, _, _, W, _ = rbf_case
    E_idx = np.random.RandomState(1).randint(0, 40, (2, 40, 8))
    Xt, Mt, Et, Wt = _t(X, Xm, E_idx, W)
    out = rbf_edge.rbf_edge_features(Xt, Mt, Et, Wt)
    ref = jax_rbf_dense(jnp.asarray(X), jnp.asarray(Xm),
                        jnp.asarray(E_idx.astype(np.int32)), jnp.asarray(W),
                        interpret=True)
    assert out.shape == (2, 40, 8, 32)
    assert _rel(out.numpy(), ref) < 5e-6
    with jax.enable_x64(True):
        ref64 = np.asarray(jax_all_pair_rbf(
            jnp.asarray(X, jnp.float64), jnp.asarray(E_idx),
            jnp.asarray(Xm, jnp.float64), 16) @ jnp.asarray(W, jnp.float64))
    out64 = rbf_edge.rbf_edge_features(*_t(X, Xm, E_idx, W, dtype=torch.float64))
    np.testing.assert_allclose(out64.numpy(), ref64, atol=1e-10, rtol=0)


def test_rbf_dense_qk_equals_the_structure_rows(rbf_case):
    X, Xm, sl, E_idx, W, _ = rbf_case
    Xq, Mq, Xt, Mt, Wt = _t(X[:, sl], Xm[:, sl], X, Xm, W, dtype=torch.float64)
    E_full = np.zeros((2, 40, 8), np.int64)
    E_full[:, sl] = E_idx
    qk = rbf_edge.rbf_edge_features_qk(Xq, Mq, Xt, Mt, torch.from_numpy(E_idx), Wt)
    full = rbf_edge.rbf_edge_features(Xt, Mt, torch.from_numpy(E_full), Wt)
    np.testing.assert_allclose(qk.numpy(), full[:, sl].numpy(), atol=1e-12,
                               rtol=0)


def test_rbf_dense_dw_matches_pallas_unpermuted(rbf_case):
    X, Xm, sl, E_idx, W, G = rbf_case
    got = rbf_edge.rbf_edge_dw_plain(*_t(X[:, sl], Xm[:, sl], E_idx, G, X, Xm))
    # the Pallas kernel's operands: x|y|z planes of the query rows and of
    # the gathered neighbour rows, one row per edge, padded to EDGE_TILE
    B, Lq, K = E_idx.shape
    planes = np.concatenate([X[..., c] for c in range(3)], axis=-1)
    Xi = np.repeat(planes[:, sl], K, axis=1).reshape(-1, 54)
    Mi = np.repeat(Xm[:, sl], K, axis=1).reshape(-1, 18)
    Xj = np.stack([planes[b][E_idx[b].reshape(-1)] for b in range(B)]).reshape(-1, 54)
    Mj = np.stack([Xm[b][E_idx[b].reshape(-1)] for b in range(B)]).reshape(-1, 18)
    E = B * Lq * K
    pad = lambda a: np.pad(a, ((0, -E % EDGE_TILE), (0, 0)))  # noqa: E731
    dw_kernel = np.asarray(rbf_edge_embed_dw(
        *[jnp.asarray(pad(a)) for a in (Xi, Xj, Mi, Mj, G.reshape(E, -1))],
        interpret=True))
    ref = np.empty_like(dw_kernel)
    ref[rbf_weight_permutation()] = dw_kernel     # kernel order -> reference
    assert got.shape == (5184, 32)
    assert np.abs(got.numpy() - ref).max() <= 5e-5 * np.abs(ref).max()


def test_rbf_dense_dw_matches_autograd_float64(rbf_case):
    X, Xm, sl, E_idx, W, G = rbf_case
    Xq, Mq, Xt, Mt, Et, Wt, Gt = _t(X[:, sl], Xm[:, sl], X, Xm, E_idx, W, G,
                                    dtype=torch.float64)
    Wr = Wt.clone().requires_grad_(True)
    ref, = torch.autograd.grad(
        rbf_edge.rbf_edge_features_plain(Xq, Mq, Et, Wr, Xt, Mt), Wr, Gt)
    got = rbf_edge.rbf_edge_dw_plain(Xq, Mq, Et, Gt, Xt, Mt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10, rtol=0)
    # the autograd Function the features run: a gradient for W only
    Xr = Xq.clone().requires_grad_(True)
    fn, gx = torch.autograd.grad(rbf_edge.rbf_edge_features_qk(
        Xr, Mq, Xt, Mt, Et, Wr), (Wr, Xr), Gt, allow_unused=True)
    np.testing.assert_allclose(fn.numpy(), ref.numpy(), atol=1e-10, rtol=0)
    assert gx is None


def _table_case(mode, B=2, L=6, Lk=20, K=5, H=16, seed=2):
    """One message-table launch at float64: L query nodes per structure
    against a table of Lk rows per structure."""
    rng = np.random.RandomState(seed)
    N, C = B * L, (2 * H if mode == "dec" else H)
    f = lambda *s: torch.from_numpy(rng.randn(*s) * 0.5)  # noqa: E731
    a = {"h_V2": f(N, H), "h_E2": f(N * K, H), "table2": f(B * Lk, C),
         "eidx2": torch.from_numpy(rng.randint(0, Lk, N * K)),
         "wa": f(H, H) / 4, "wb": f(H, H) / 4, "b1": f(H), "w2": f(H, H) / 4,
         "b2": f(H), "w3": f(H, H) / 4, "b3": f(H)}
    m = torch.from_numpy((rng.rand(N * K) > 0.2) * 1.0)
    a["mask"] = torch.ones(N * K, dtype=torch.float64) if mode == "enc_edge" else m
    a["mbw"] = (m * torch.from_numpy((rng.rand(N * K) > 0.5) * 1.0)
                if mode == "dec" else torch.ones(N * K, dtype=torch.float64))
    a["g"] = f(N * K if mode == "enc_edge" else N, H)
    return a, B, L, Lk, K, H


def _by_hand(mode, a, B, L, Lk, K, H):
    """The message table with the neighbour rows gathered by explicit
    loops from each structure's Lk-row table."""
    tab = a["table2"].view(B, Lk, -1)
    eidx = a["eidx2"].view(B, L, K)
    rows = torch.stack([torch.stack([torch.stack([tab[b, eidx[b, i, k]]
                                                  for k in range(K)])
                                     for i in range(L)]) for b in range(B)])
    rows = rows.reshape(B * L * K, -1)
    x = (a["h_V2"] @ a["wa"]).repeat_interleave(K, 0) + a["b1"]
    e = a["h_E2"] @ a["wb"]
    if mode == "dec":
        m1, mb = a["mask"][:, None], a["mbw"][:, None]
        x = x + m1 * e + mb * rows[:, :H] + m1 * rows[:, H:]
    else:
        x = x + e + rows
    m = gelu(gelu(x) @ a["w2"] + a["b2"]) @ a["w3"] + a["b3"]
    if mode == "enc_node":
        m = m * a["mask"][:, None]
    if mode != "enc_edge":
        m = m.view(B * L, K, H).sum(1) / 30.0
    return m


ARGS = ("h_V2", "h_E2", "table2", "eidx2", "mask", "mbw", "wa", "wb", "b1",
        "w2", "b2", "w3", "b3")
GRADS = ("h_V2", "h_E2", "table2", "wa", "wb", "b1", "w2", "b2", "w3", "b3")


@pytest.mark.parametrize("mode", ["enc_node", "enc_edge", "dec"])
def test_message_table_with_key_length_float64(mode):
    a, B, L, Lk, K, H = _table_case(mode)
    out = mk.message_table_plain(mode, *[a[k] for k in ARGS], K=K, L=L, Lk=Lk)
    leaves = {k: a[k].clone().requires_grad_(True) for k in GRADS}
    ref = _by_hand(mode, {**a, **leaves}, B, L, Lk, K, H)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), atol=1e-10,
                               rtol=0)
    want = torch.autograd.grad(ref, [leaves[k] for k in GRADS], a["g"])
    _, x = mk.message_table_plain(mode, *[a[k] for k in ARGS], K=K, L=L, Lk=Lk,
                                  save_x=True)
    got = mk.message_table_bwd_plain(mode, a["h_V2"], a["h_E2"], x,
                                     *[a[k] for k in ARGS[3:]], a["g"], K=K,
                                     L=L, Lk=Lk)
    order = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9)   # g_hV, g_ein, g_table, dwa, ...
    for i, name in zip(order, GRADS):
        assert got[i].shape == want[i].shape, name
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-10,
                                   rtol=0, err_msg=name)
    assert got[2].shape == (B * Lk, a["table2"].shape[1])
    # the autograd Function the layers run (plain versions on the CPU)
    leaves2 = {k: a[k].clone().requires_grad_(True) for k in GRADS}
    fn = torch.autograd.grad(
        mk.message_table(mode, *[leaves2.get(k, a[k]) for k in ARGS], K=K, L=L,
                         Lk=Lk), [leaves2[k] for k in GRADS], a["g"])
    for name, f, w in zip(GRADS, fn, want):
        np.testing.assert_allclose(f.numpy(), w.numpy(), atol=1e-10, rtol=0,
                                   err_msg=name)


def test_new_cuda_entry_points_refuse_cpu_tensors():
    X, m = torch.zeros(1, 8, 3), torch.ones(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_graph_qk_cuda(X[:, :4], X, m[:, :4], m, 4)
    Xa, Xm = torch.zeros(1, 8, 18, 3), torch.ones(1, 8, 18)
    E = torch.zeros(1, 8, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        rbf_edge.rbf_edge_cuda(Xa, Xm, E, torch.zeros(5184, 32))
    with pytest.raises(ValueError, match="CUDA"):
        rbf_edge.rbf_edge_dw_cuda(Xa, Xm, E, torch.zeros(1, 8, 4, 32))

"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its XLA formulations, on
the same inputs made with numpy.

Tolerances: kNN indices are exact and distances agree to 1e-5 (the two
sum the squared differences in another order); the RBF projection agrees
to 2e-6 relative (fp32, different summation order over 5184 rows); the
message MLP to 1e-5 relative, because the Pallas kernel's GELU uses the
Abramowitz-Stegun erf (error up to 1.5e-7) and the port the exact erf."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models.features import all_pair_rbf as jax_all_pair_rbf
from na_mpnn_tpu.models.features import knn_graph as jax_knn_graph
from na_mpnn_tpu.models.modules import init_dec_layer, init_enc_layer
from na_mpnn_tpu.ops import message_kernels as jmk
from na_mpnn_tpu.ops.knn import knn_graph_pallas
from na_mpnn_tpu.ops.rbf_classed import rbf_edge_features_classed as jax_rbf

from na_mpnn_tpu_torch.ops import knn, message_kernels, rbf_classed, rbf_common
from na_mpnn_tpu_torch.params import from_jax_params


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _knn_case(B, L, seed, masked_block=False):
    rng = np.random.RandomState(seed)
    X = (np.cumsum(rng.randn(B, L, 3) * 3.0, axis=1)).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    if masked_block:
        mask[0, 10:25] = 0
        mask[-1, -7:] = 0
    return X, mask


@pytest.mark.parametrize("B,L,masked", [(2, 64, True), (1, 100, False),
                                        (2, 20, True)])
def test_knn_matches_pallas_and_xla(B, L, masked):
    X, mask = _knn_case(B, L, seed=L, masked_block=masked)
    k = 16
    D_t, E_t = knn.knn_graph(torch.from_numpy(X), torch.from_numpy(mask), k)
    D_p, E_p = knn_graph_pallas(jnp.asarray(X), jnp.asarray(mask), k=k,
                                interpret=True)
    D_x, E_x = jax_knn_graph(jnp.asarray(X), jnp.asarray(mask), k)
    assert E_t.shape == (B, L, k)
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_p))
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_x))
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_p), atol=1e-5)
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_x), atol=1e-5)


@pytest.fixture
def rbf_case():
    """Mixed-class fixture: protein rows, NA rows, empty rows and one
    residue carrying atoms of both blocks."""
    rng = np.random.RandomState(0)
    B, L, K, A, R, H = 2, 40, 8, 18, 16, 32
    X = rng.randn(B, L, A, 3).astype(np.float32) * 5
    Xm = np.zeros((B, L, A), np.float32)
    Xm[:, :20, [0, 1, 2, 3, 16]] = 1
    Xm[:, 20:, 4:16] = 1
    Xm[:, 20:, 17] = 1
    Xm[:, 38:] = 0
    Xm[0, 5, 4] = 1
    E_idx = rng.randint(0, L, (B, L, K)).astype(np.int32)
    W = rng.randn(A * A * R, H).astype(np.float32) * 0.01
    return X, Xm, E_idx, W


def test_rbf_classed_matches_pallas_and_dense(rbf_case):
    X, Xm, E_idx, W = rbf_case
    out = rbf_classed.rbf_edge_features_classed(
        torch.from_numpy(X), torch.from_numpy(Xm),
        torch.from_numpy(E_idx).long(), torch.from_numpy(W)).numpy()
    pallas = jax_rbf(jnp.asarray(X), jnp.asarray(Xm), jnp.asarray(E_idx),
                     jnp.asarray(W), interpret=True)
    dense = jax_all_pair_rbf(jnp.asarray(X), jnp.asarray(E_idx),
                             jnp.asarray(Xm), 16) @ jnp.asarray(W)
    assert out.shape == (2, 40, 8, 32)
    assert _rel(out, pallas) < 2e-6
    assert _rel(out, dense) < 2e-6


def test_rbf_group_tables_cover_the_weight_once():
    rows = np.concatenate(rbf_common.group_rows())
    assert len(rows) == len(set(rows.tolist()))
    sizes = [len(r) for r in rbf_common.group_rows()]
    assert sizes == [400, 1040, 1040, 2704]
    assert sorted(rbf_common.PERM) == list(range(18))


@pytest.fixture
def table_case():
    rng = np.random.RandomState(1)
    B, L, K, H = 2, 32, 8, 32
    N = B * L
    enc = jax.tree.map(np.asarray, init_enc_layer(jax.random.PRNGKey(0), H, 2 * H))
    dec = jax.tree.map(np.asarray, init_dec_layer(jax.random.PRNGKey(1), H, 3 * H))
    for p in (enc, dec):   # nonzero biases, so a misplaced bias shows
        for w in ("W1", "W2", "W3", "W11", "W12", "W13"):
            if w in p:
                p[w]["b"] = rng.randn(H).astype(np.float32) * 0.1
    arrays = {
        "h_V2": rng.randn(N, H).astype(np.float32) * 0.5,
        "h_E2": rng.randn(N * K, H).astype(np.float32) * 0.5,
        "table": rng.randn(N, H).astype(np.float32) * 0.5,
        "table2": rng.randn(N, 2 * H).astype(np.float32) * 0.5,
        "eidx2": rng.randint(0, L, N * K).astype(np.int32),
        "m_att": (rng.rand(N * K) > 0.2).astype(np.float32),
        "mbw": (rng.rand(N * K) > 0.5).astype(np.float32),
    }
    return enc, dec, arrays, K, L


@pytest.mark.parametrize("mode", ["enc_node", "enc_edge", "dec"])
def test_message_table_matches_pallas(table_case, mode):
    enc, dec, a, K, L = table_case
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["eidx2"] = t["eidx2"].long()
    col = lambda x: x[:, None]  # noqa: E731 — the JAX wrappers take [N*K, 1]
    pe = from_jax_params(enc, device="cpu")
    pd = from_jax_params(dec, device="cpu")
    if mode == "enc_node":
        ref = jmk.message_agg_table_flat(enc, j["h_V2"], j["h_E2"], j["table"],
                                         col(j["eidx2"]), col(j["m_att"]),
                                         K=K, L=L, interpret=True)
        out = message_kernels.message_agg_table_flat(
            pe, t["h_V2"], t["h_E2"], t["table"], t["eidx2"], t["m_att"], K=K, L=L)
    elif mode == "enc_edge":
        ref = jmk.message_edge_table_flat(enc, j["h_V2"], j["h_E2"], j["table"],
                                          col(j["eidx2"]), K=K, L=L,
                                          interpret=True)
        out = message_kernels.message_edge_table_flat(
            pe, t["h_V2"], t["h_E2"], t["table"], t["eidx2"], K=K, L=L)
    else:
        m1d = np.ones_like(a["m_att"])
        m1d[:40] = 0.0
        mbw = a["mbw"] * m1d
        ref = jmk.message_dec_table_flat(dec, j["h_V2"], j["h_E2"], j["table2"],
                                         col(j["eidx2"]), col(jnp.asarray(m1d)),
                                         col(jnp.asarray(mbw)), K=K, L=L,
                                         interpret=True)
        out = message_kernels.message_dec_table_flat(
            pd, t["h_V2"], t["h_E2"], t["table2"], t["eidx2"],
            torch.from_numpy(m1d), torch.from_numpy(mbw), K=K, L=L)
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < 1e-5


def test_kernel_wrappers_refuse_cpu_tensors_for_the_kernel():
    """The CUDA entry points take CUDA tensors only: no silent CPU path."""
    X, mask = _knn_case(1, 20, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn_graph_cuda(torch.from_numpy(X), torch.from_numpy(mask), 8)

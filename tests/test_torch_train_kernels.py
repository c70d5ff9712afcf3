"""The port's backward kernels on the CPU (their plain versions and the
autograd Functions around the kernels) against torch autograd at float64
and against the JAX package's Pallas backward kernels in interpret mode at
fp32, on the same inputs made with numpy.

Tolerances: float64 against autograd, 1e-10 (the same function, summed in
another order). Against the Pallas kernels, 5e-6 relative on g_hV, g_ein
and g_table and 5e-5 on the weight gradients, the bars of
``test_message_kernels.py``: the Pallas kernel's GELU and GELU derivative use
the Abramowitz-Stegun erf (error up to 1.5e-7), the port the exact erf, and
the weight gradients sum 512 edge rows. The RBF weight gradient agrees with
``jax.grad`` of the Pallas projection to 2e-5 relative (fp32 sums over the
edges in another order), as ``test_message_kernels.py`` holds the Pallas
kernel to the dense form."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import message_kernels as jmk
from na_mpnn_tpu.ops.rbf_classed import rbf_edge_features_classed as jax_rbf

from na_mpnn_tpu_torch.ops import message_kernels as mk
from na_mpnn_tpu_torch.ops import rbf_classed

MODES = ["enc_node", "enc_edge", "dec"]
GRAD_NAMES = ("g_hV", "g_ein", "g_table", "dwa", "dwb", "db1", "dw2", "db2",
              "dw3", "db3")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


def _case(mode, dtype, B=2, L=32, K=8, H=128, seed=3):
    """Inputs of one message-table launch as numpy arrays (random biases;
    decoder masks with m1d = 0 on some edges and mbw <= m1d)."""
    rng = np.random.RandomState(seed)
    N = B * L
    C = 2 * H if mode == "dec" else H
    f = lambda *s: (rng.randn(*s) * 0.5).astype(dtype)  # noqa: E731
    a = {"h_V2": f(N, H), "h_E2": f(N * K, H), "table2": f(N, C),
         "eidx2": rng.randint(0, L, N * K).astype(np.int64),
         "wa": f(H, H) / 8, "wb": f(H, H) / 8, "b1": f(H), "w2": f(H, H) / 8,
         "b2": f(H), "w3": f(H, H) / 8, "b3": f(H)}
    if mode == "enc_node":
        a["mask"] = (rng.rand(N * K) > 0.2).astype(dtype)
        a["mbw"] = np.zeros(N * K, dtype)
    elif mode == "enc_edge":
        a["mask"] = a["mbw"] = np.ones(N * K, dtype)
    else:
        a["mask"] = (rng.rand(N * K) > 0.2).astype(dtype)
        a["mbw"] = a["mask"] * (rng.rand(N * K) > 0.5).astype(dtype)
    a["g"] = f(N * K if mode == "enc_edge" else N, H)
    return a, K, L


def _port_args(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return t, (t["h_V2"], t["h_E2"], t["table2"], t["eidx2"], t["mask"],
               t["mbw"], t["wa"], t["wb"], t["b1"], t["w2"], t["b2"], t["w3"],
               t["b3"])


@pytest.mark.parametrize("mode", MODES)
def test_message_table_bwd_plain_matches_autograd_float64(mode):
    a, K, L = _case(mode, np.float64, B=2, L=12, K=5, H=32)
    t, args = _port_args(a)
    diff = [0, 1, 2, 6, 7, 8, 9, 10, 11, 12]
    leaves = [args[i].clone().requires_grad_(True) for i in diff]
    full = list(args)
    for i, leaf in zip(diff, leaves):
        full[i] = leaf
    ref = torch.autograd.grad(mk.message_table_plain(mode, *full, K=K, L=L),
                              leaves, t["g"])
    _, x = mk.message_table_plain(mode, *args, K=K, L=L, save_x=True)
    plain = mk.message_table_bwd_plain(mode, args[0], args[1], x, *args[3:],
                                       t["g"], K=K, L=L)
    # the autograd Function the model runs (plain versions on the CPU)
    fn = torch.autograd.grad(mk.message_table(mode, *full, K=K, L=L), leaves,
                             t["g"])
    for name, r, p, f in zip(GRAD_NAMES, ref, plain, fn):
        np.testing.assert_allclose(p.numpy(), r.numpy(), atol=1e-10, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(f.numpy(), r.numpy(), atol=1e-10, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_message_table_bwd_matches_pallas(mode):
    a, K, L = _case(mode, np.float32)
    t, args = _port_args(a)
    col = lambda v: jnp.asarray(v)[:, None]  # noqa: E731
    row = lambda v: jnp.asarray(v)[None, :]  # noqa: E731
    dec, agg = mode == "dec", mode != "enc_edge"
    jargs = (jnp.asarray(a["h_V2"]), jnp.asarray(a["h_E2"]),
             jnp.asarray(a["table2"]), col(a["eidx2"].astype(np.int32)),
             col(a["mask"]), col(a["mbw"]), jnp.asarray(a["wa"]),
             jnp.asarray(a["wb"]), row(a["b1"]), jnp.asarray(a["w2"]),
             row(a["b2"]), jnp.asarray(a["w3"]), row(a["b3"]))
    _, x_j = jmk._message_table_fwd_call(*jargs, K, L, jnp.float32, dec, agg,
                                         True, save_x=True)
    _, x = mk.message_table_plain(mode, *args, K=K, L=L, save_x=True)
    assert _rel(x.numpy(), x_j) < 1e-6
    H = a["wa"].shape[0]
    ref = jmk._message_table_bwd_call(
        jargs[0], jargs[1], x_j, *jargs[3:], jnp.asarray(a["g"]), K, L,
        2 * H if dec else H, jnp.float32, dec, agg, True)
    got = mk.message_table_bwd_plain(mode, args[0], args[1],
                                     torch.from_numpy(np.array(x_j)),
                                     *args[3:], t["g"], K=K, L=L)
    for i, (name, r, p) in enumerate(zip(GRAD_NAMES, ref, got)):
        r = np.asarray(r).reshape(p.shape)
        tol = 5e-6 if i < 3 else 5e-5
        assert _rel(p.numpy(), r) < tol, (name, _rel(p.numpy(), r))


@pytest.fixture
def rbf_case():
    """The mixed-class case of ``test_message_kernels.py``: protein rows, NA
    rows, empty rows and one residue with atoms of both blocks; plus a
    random cotangent of the projection."""
    rng = np.random.RandomState(0)
    B, L, K, A, R, H = 2, 40, 8, 18, 16, 128
    X = rng.randn(B, L, A, 3).astype(np.float32) * 5
    Xm = np.zeros((B, L, A), np.float32)
    Xm[:, :20, [0, 1, 2, 3, 16]] = 1
    Xm[:, 20:, 4:16] = 1
    Xm[:, 20:, 17] = 1
    Xm[:, 38:] = 0
    Xm[0, 5, 4] = 1
    E_idx = rng.randint(0, L, (B, L, K)).astype(np.int32)
    W = rng.randn(A * A * R, H).astype(np.float32) * 0.01
    G = rng.randn(B, L, K, H).astype(np.float32)
    return X, Xm, E_idx, W, G


def test_rbf_classed_dw_matches_pallas_grad(rbf_case):
    X, Xm, E_idx, W, G = rbf_case
    ref = jax.grad(lambda w: jnp.sum(jax_rbf(
        jnp.asarray(X), jnp.asarray(Xm), jnp.asarray(E_idx), w,
        interpret=True) * jnp.asarray(G)))(jnp.asarray(W))
    got = rbf_classed.rbf_classed_dw_plain(
        torch.from_numpy(X), torch.from_numpy(Xm),
        torch.from_numpy(E_idx).long(), torch.from_numpy(G))
    assert got.shape == (18 * 18 * 16, 128)
    assert _rel(got.numpy(), ref) < 2e-5


def test_rbf_classed_dw_matches_autograd_float64(rbf_case):
    X, Xm, E_idx, W, G = (torch.from_numpy(v.astype(np.float64))
                          for v in rbf_case)
    E_idx = E_idx.long()
    Wr = W.clone().requires_grad_(True)
    dense = rbf_classed.rbf_edge_features_classed_plain(X, Xm, E_idx, Wr)
    ref, = torch.autograd.grad(dense, Wr, G)
    got = rbf_classed.rbf_classed_dw_plain(X, Xm, E_idx, G)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-10, rtol=0)
    # the autograd Function the features run: a gradient for W only
    Xr = X.clone().requires_grad_(True)
    out = rbf_classed.rbf_edge_features_classed(Xr, Xm, E_idx, Wr)
    fn, gx = torch.autograd.grad(out, (Wr, Xr), G, allow_unused=True)
    np.testing.assert_allclose(fn.numpy(), ref.numpy(), atol=1e-10, rtol=0)
    assert gx is None


def test_backward_kernels_refuse_cpu_tensors():
    """The CUDA entry points take CUDA tensors only: no silent CPU path."""
    a, K, L = _case("enc_node", np.float32, B=1, L=8, K=4, H=32)
    t, args = _port_args(a)
    with pytest.raises(ValueError, match="CUDA"):
        mk.message_table_bwd_cuda("enc_node", args[0], args[1], args[1],
                                  *args[3:], t["g"], K=K, L=L)
    X = torch.zeros(1, 8, 18, 3)
    with pytest.raises(ValueError, match="CUDA"):
        rbf_classed.rbf_classed_dw_cuda(X, torch.ones(1, 8, 18),
                                        torch.zeros(1, 8, 4, dtype=torch.long),
                                        torch.zeros(1, 8, 4, 32))

"""The bf16 variants of kernel rows 3, 4, 9, 10, 11 and 12 on the CPU: each
plain bf16 version (the function its CUDA kernel computes, and what
``kernels="torch"`` runs) against the JAX package's Pallas kernel at
``compute_dtype=bfloat16`` in interpret mode, on the same inputs made from a
seed with numpy and rounded to bf16 first.

Tolerances. bf16 keeps 8 significant bits (unit roundoff 2^-8 = 3.9e-3). The
two sides round at the same points, but XLA on the CPU keeps excess
precision inside fused bf16 chains and sums in other orders, so a value that
lies near a rounding boundary can round to the neighbouring bf16 number on
one side only, and moves what it feeds by one bf16 step of itself.
* Rows 9-12 (bf16 outputs): 2^-6 of the output's largest magnitude, four
  bf16 steps of the largest value: one flip upstream plus the output's own
  rounding, on either side.
* Rows 3, 4 (fp32 outputs, sums of many bf16 products): 2^-8 of the largest
  magnitude. The JAX kernel selects the coordinates in bf16x2 (error up to
  2^-17 of a coordinate), the port takes exact fp32 distances, so a bin near
  a rounding boundary may round apart; one flipped bin moves a sum by 2^-8
  of that one term.
* The damped bins before rounding (fp32): 1e-5 relative, the fp32 exps of
  two libraries and 15 chained products.
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.ops import fused_layers as jfl
from na_mpnn_tpu.ops import message_kernels as jmk
from na_mpnn_tpu.ops import rbf_classed as jrbf

from na_mpnn_tpu_torch.models.features import RBF_D_MAX, RBF_D_MIN
from na_mpnn_tpu_torch.ops import LAUNCHES, reset_launches
from na_mpnn_tpu_torch.ops import fused_layers as fl
from na_mpnn_tpu_torch.ops import message_kernels as mk
from na_mpnn_tpu_torch.ops import rbf_classed
from na_mpnn_tpu_torch.params import from_jax_params
from test_torch_fused_layers import _layers, _operands

BF = jnp.bfloat16
TOL_BF16 = 2.0 ** -6
TOL_RBF = 2.0 ** -8
H = 128


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


def _r16(a):
    """numpy fp32 values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _t16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_damped_bins_match_jax_recursion():
    """``bins_damped`` is the JAX ``_bins_recursive`` (fp32, before the bf16
    rounding), and with the fold scales it is the exact Gaussian bin."""
    D = np.concatenate([np.linspace(0.0, 50.0, 4001),
                        [1e-3, 2.0, 22.0, 49.999]]).astype(np.float32)
    want = np.stack([_np(b) for b in jrbf._bins_recursive(jnp.asarray(D), 16,
                                                          jnp.float32)], -1)
    got = rbf_classed.bins_damped(torch.from_numpy(D)).numpy()
    # atol: XLA on the CPU flushes subnormal products to 0, PyTorch (and the
    # CUDA kernel, built without fast math) keeps them
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1.2e-38)
    mu = np.linspace(RBF_D_MIN, RBF_D_MAX, 16)
    sigma = (RBF_D_MAX - RBF_D_MIN) / 16
    exact = np.exp(-((D[:, None].astype(np.float64) - mu) / sigma) ** 2)
    folded = got.astype(np.float64) * rbf_classed.bin_fold_scales()
    # the walks are damped by up to e^-64, so a true bin below about
    # 6e-11 (fp32's least normal times e^64) may underflow to 0
    big = exact > 1e-9
    np.testing.assert_allclose(folded[big], exact[big], rtol=1e-4)
    np.testing.assert_array_equal(rbf_classed.bin_fold_scales(),
                                  jrbf.bin_fold_scales())


def test_rbf_classed_bf16_and_its_weight_gradient_match_pallas():
    """Rows 3 and 4 at bf16 (forward, and the gradient of the reference-order
    weight through the fold scales), with protein and nucleic residues,
    absent atoms and a fully masked row."""
    rng = np.random.RandomState(0)
    B, L, K = 2, 40, 8
    X = (rng.randn(B, L, 18, 3) * 5).astype(np.float32)
    Xm = np.zeros((B, L, 18), np.float32)
    Xm[:, :20, [0, 1, 2, 3, 16]] = 1
    Xm[:, 20:, 4:16] = 1
    Xm[:, 20:, 17] = 1
    Xm[:, 38:] = 0
    Xm[0, 5, 4] = 1
    E_idx = rng.randint(0, L, (B, L, K)).astype(np.int32)
    W = (rng.randn(18 * 18 * 16, H) * 0.01).astype(np.float32)
    G = rng.randn(B, L, K, H).astype(np.float32)

    def jax_rbf(w):
        return jrbf.rbf_edge_features_classed(
            jnp.asarray(X), jnp.asarray(Xm), jnp.asarray(E_idx), w,
            compute_dtype=BF, interpret=True)

    out_j = jax_rbf(jnp.asarray(W))
    dw_j = jax.grad(lambda w: jnp.sum(jax_rbf(w) * jnp.asarray(G)))(jnp.asarray(W))
    Wt = torch.from_numpy(W).requires_grad_(True)
    reset_launches()
    out = rbf_classed.rbf_edge_features_classed(
        torch.from_numpy(X), torch.from_numpy(Xm), torch.from_numpy(E_idx).long(),
        Wt, low=True)
    dw, = torch.autograd.grad(out, Wt, torch.from_numpy(G))
    assert not any(LAUNCHES.values())
    assert out.dtype == dw.dtype == torch.float32
    assert _rel(out.detach(), out_j) < TOL_RBF
    assert _rel(dw, dw_j) < TOL_RBF
    empty = np.asarray(out_j) == 0.0
    assert empty.any() and np.all(out.detach().numpy()[empty] == 0.0)


MODES = ("enc_node", "enc_edge", "dec")
GRADS = ("g_hV", "g_ein", "g_table", "dwa", "dwb", "db1", "dw2", "db2", "dw3",
         "db3")


def _table_case(mode, B=2, L=32, K=8, seed=3):
    rng = np.random.RandomState(seed)
    N = B * L
    C = 2 * H if mode == "dec" else H

    def f(*shape, scale=0.5):
        return _r16(rng.randn(*shape) * scale)

    a = {"h_V2": f(N, H), "h_E2": f(N * K, H), "table2": f(N, C),
         "wa": f(H, H, scale=1 / 16), "wb": f(H, H, scale=1 / 16), "b1": f(H),
         "w2": f(H, H, scale=1 / 16), "b2": f(H), "w3": f(H, H, scale=1 / 16),
         "b3": f(H)}
    eidx = rng.randint(0, L, N * K).astype(np.int64)
    if mode == "enc_edge":
        m, mbw = np.ones(N * K, np.float32), np.ones(N * K, np.float32)
    else:
        m = (rng.rand(N * K) > 0.2).astype(np.float32)
        mbw = (m * (rng.rand(N * K) > 0.5) if mode == "dec"
               else np.zeros(N * K)).astype(np.float32)
    g = f(N * K if mode == "enc_edge" else N, H)
    return a, eidx, m, mbw, g, K, L


@pytest.mark.parametrize("mode", MODES)
def test_message_table_bf16_and_backward_match_pallas(mode):
    """Rows 9 and 10 at bf16: the output, the saved pre-GELU ``x`` and all
    ten backward outputs (as the JAX custom VJP returns them: the fp32 table
    and weight gradients rounded once to bf16)."""
    a, eidx, m, mbw, g, K, L = _table_case(mode)
    keys = ("h_V2", "h_E2", "table2")
    weights = ("wa", "wb", "b1", "w2", "b2", "w3", "b3")
    targs = ([_t16(a[k]) for k in keys] + [torch.from_numpy(eidx), _t16(m), _t16(mbw)]
             + [_t16(a[k]) for k in weights])
    row = {"b1", "b2", "b3"}
    jargs = ([jnp.asarray(a[k], BF) for k in keys]
             + [jnp.asarray(eidx.astype(np.int32))[:, None],
                jnp.asarray(m, BF)[:, None], jnp.asarray(mbw, BF)[:, None]]
             + [jnp.asarray(a[k], BF)[None, :] if k in row else jnp.asarray(a[k], BF)
                for k in weights])
    dec, agg = mode == "dec", mode != "enc_edge"
    out_j, x_j = jmk._message_table_fwd_call(*jargs, K, L, BF, dec, agg, True,
                                             save_x=True)
    out, x = mk.message_table_plain(mode, *targs, K=K, L=L, save_x=True)
    assert out.dtype == x.dtype == torch.bfloat16
    assert _rel(out.float(), _np(out_j)) < TOL_BF16
    assert _rel(x.float(), _np(x_j)) < TOL_BF16

    # the backward from JAX's saved x, so that both resume from one x
    C = 2 * H if dec else H
    want = jmk._message_table_bwd_call(*jargs[:2], x_j, *jargs[3:],
                                       jnp.asarray(g, BF), K, L, C, BF, dec, agg,
                                       True)
    got = mk.message_table_bwd_plain(mode, targs[0], targs[1], _t16(_np(x_j)),
                                     *targs[3:], _t16(g), K=K, L=L)
    for name, w, t in zip(GRADS, want, got):
        assert t.dtype == torch.bfloat16, name
        w = _np(jnp.asarray(w).astype(BF)).reshape(t.shape)
        assert _rel(t.float(), w) < TOL_BF16, name


@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("kind", ["enc", "dec", "edge"])
def test_fused_updates_bf16_match_pallas(kind, K):
    """Rows 11 and 12 at bf16: the encoder and decoder node updates and the
    edge update, every operand and parameter bf16, bf16 outputs."""
    B, L = 2, 40
    o = {k: (_r16(v) if v.dtype == np.float32 else v)
         for k, v in _operands(B, L, K, seed=K + len(kind)).items()}
    pe, pd = _layers(K)
    p = jax.tree.map(_r16, pd if kind == "dec" else pe)
    jp = jax.tree.map(lambda v: jnp.asarray(v, BF), p)
    tp = from_jax_params(p, device="cpu", dtype=torch.bfloat16)
    J = lambda v: jnp.asarray(v, BF)
    eidx = torch.from_numpy(o["eidx"])
    if kind == "edge":
        want = jfl.fused_edge_update(J(o["h_V"]), J(o["h_E"]), J(o["table"][o["row"]]),
                                     jp, K, compute_dtype=BF, interpret=True)
        got = fl.fused_edge_update_plain(tp, _t16(o["h_V"]), _t16(o["h_E"]),
                                         _t16(o["table"]), eidx, K=K, L=L)
    elif kind == "enc":
        want = jfl.fused_node_update(
            J(o["h_V"]), J(o["h_E"]), J(o["table"][o["row"]]), jp["W1"]["w"][H:2 * H],
            J(o["m_att"])[:, None], J(o["mask"])[:, None], jp, K,
            compute_dtype=BF, interpret=True)
        got = fl.fused_node_update_plain(
            "enc", tp, _t16(o["h_V"]), _t16(o["h_E"]), _t16(o["table"]), eidx,
            _t16(o["m_att"]), None, _t16(o["mask"]), K=K, L=L)
    else:
        # the JAX decoder variant: the e-term rides the static slot, the
        # causal context the G slot (dec_layer_fused's operands)
        wb = p["W1"]["w"][H:2 * H].astype(np.float64)
        static = o["m1d"][:, None] * (o["h_E"].astype(np.float64) @ wb)
        g = o["table2"][o["row"]].astype(np.float64)
        G = o["mbw"][:, None] * g[:, :H] + o["m1d"][:, None] * g[:, H:]
        want = jfl.fused_node_update(
            J(o["h_V"]), J(static), J(G), jnp.zeros((H, H), BF),
            jnp.ones((B * L * K, 1), BF), J(o["mask"])[:, None], jp, K,
            compute_dtype=BF, has_static=True, interpret=True)
        got = fl.fused_node_update_plain(
            "dec", tp, _t16(o["h_V"]), _t16(o["h_E"]), _t16(o["table2"]), eidx,
            _t16(o["m1d"]), _t16(o["mbw"]), _t16(o["mask"]), K=K, L=L)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), _np(want)) < TOL_BF16

"""The port's training forward + ``loss_smoothed`` (plain path on the CPU,
through the autograd Functions of the message-table and RBF kernels) against
the JAX package's ``forward(kernels="xla")`` + ``loss_smoothed`` under
``jax.value_and_grad``, at float64 and the released width (H=128, K=32, 3+3
layers): the loss and every parameter gradient agree within 1e-8, the bar
``test_parity_model.py`` sets. Dropout and noise are off and the decode
order is given (the two packages' random streams differ); the PPM soft-label
mask is active.

At L = 50 (B = 2) the JAX training decoder runs the pre-gathered message MLP
(``message_agg_batched``, rows 7 and 8) and so does the port's (its gathered
route): the loss and every gradient match JAX ``forward(kernels="xla")`` at
float64 within 1e-8, and JAX with the Pallas kernels in interpret mode at
fp32 (loss within 1e-5 relative, each gradient leaf within 1e-4 of its max:
fp32 sums in other orders, and the Pallas kernels' Abramowitz-Stegun erf)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import na_mpnn_tpu.ops as jax_ops
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train import losses as jax_losses

from na_mpnn_tpu_torch.models import ModelConfig, forward
from na_mpnn_tpu_torch.ops import message_kernels as mk
from na_mpnn_tpu_torch.params import from_jax_params
from na_mpnn_tpu_torch.train import losses
from na_mpnn_tpu_torch.train.trainer import tree_leaves
from ref_oracle import make_synthetic_structure

ATOL = 1e-8


def test_training_loss_and_gradients_float64_full_width():
    L = 40
    rng = np.random.RandomState(3)
    b = make_synthetic_structure(L=L, seed=31, n_protein=16, n_dna=16)
    b["X"] = b["X"].astype(np.float64)
    ppm = np.zeros((1, L, 33))
    ppm[..., 21:25] = rng.dirichlet(np.ones(4), size=(1, L))
    b["aligned_ppm"] = ppm
    b["ppm_mask"] = (b["dna_mask"] * (rng.rand(1, L) > 0.3)).astype(np.int32)
    b["decoding_order"] = rng.permutation(L)[None]
    tokens = 100.0

    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", dropout=0.0)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(0), cfg_j))
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        rm = jax_losses.make_polymer_restype_masks(True)

        def loss_fn(params):
            lp, _ = jax_forward(params, cfg_j, bj)
            mfl = jax_losses.mask_for_loss(bj["S"], bj["mask"]).astype(lp.dtype)
            pm = {k: bj[f"{k}_mask"] for k in ("protein", "dna", "rna")}
            return jax_losses.loss_smoothed(
                bj["S"], lp, mfl, pm, rm, weight=0.1, tokens=tokens,
                num_letters=33, ppm_mask=bj["ppm_mask"],
                aligned_ppm=bj["aligned_ppm"])[1]

        loss_j, grads_j = jax.value_and_grad(loss_fn)(
            jax.tree.map(jnp.asarray, pj))
        grads_j = [np.asarray(g) for g in jax.tree.leaves(grads_j)]

    pt = from_jax_params(pj, device="cpu", dtype=torch.float64)
    leaves = list(tree_leaves(pt))
    for leaf in leaves:
        leaf.requires_grad_(True)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    lp, _ = forward(pt, ModelConfig(dropout=0.0), bt)
    mfl = losses.mask_for_loss(bt["S"], bt["mask"]).to(lp.dtype)
    pm = {k: bt[f"{k}_mask"] for k in ("protein", "dna", "rna")}
    _, loss = losses.loss_smoothed(
        bt["S"], lp, mfl, pm, losses.make_polymer_restype_masks(True),
        weight=0.1, tokens=tokens, num_letters=33, ppm_mask=bt["ppm_mask"],
        aligned_ppm=bt["aligned_ppm"])
    loss.backward()

    assert abs(float(loss.detach()) - float(loss_j)) < ATOL
    assert len(leaves) == len(grads_j) > 100
    for i, (leaf, g_j) in enumerate(zip(leaves, grads_j)):
        assert leaf.grad is not None, i
        np.testing.assert_allclose(leaf.grad.numpy(), g_j, atol=ATOL, rtol=0,
                                   err_msg=f"leaf {i}")
    # the gradient reaches the RBF projection and every message MLP
    W_e = pt["features"]["edge_embedding"]["w"]
    assert float(W_e.grad[16:].abs().max()) > 0


def _case_b2_l50(dtype):
    """Two structures of L = 50 (B = 2), a PPM mask, a given decode order."""
    L, B = 50, 2
    rng = np.random.RandomState(5)
    parts = [make_synthetic_structure(L=L, seed=51 + i, n_protein=22, n_dna=18)
             for i in range(B)]
    b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    b["X"] = b["X"].astype(dtype)
    ppm = np.zeros((B, L, 33))
    ppm[..., 21:25] = rng.dirichlet(np.ones(4), size=(B, L))
    b["aligned_ppm"] = ppm.astype(dtype)
    b["ppm_mask"] = (b["dna_mask"] * (rng.rand(B, L) > 0.3)).astype(np.int32)
    b["decoding_order"] = np.stack([rng.permutation(L) for _ in range(B)])
    return b


def _jax_loss_grads(cfg_j, pj, b, tokens):
    """JAX ``forward`` on its training routes (``deterministic=False`` with
    no key: no noise, no dropout) + ``loss_smoothed`` -> (loss, gradient
    leaves)."""
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    rm = jax_losses.make_polymer_restype_masks(True)

    def loss_fn(params):
        lp, _ = jax_forward(params, cfg_j, bj, deterministic=False)
        mfl = jax_losses.mask_for_loss(bj["S"], bj["mask"]).astype(lp.dtype)
        pm = {k: bj[f"{k}_mask"] for k in ("protein", "dna", "rna")}
        return jax_losses.loss_smoothed(
            bj["S"], lp, mfl, pm, rm, weight=0.1, tokens=tokens, num_letters=33,
            ppm_mask=bj["ppm_mask"], aligned_ppm=bj["aligned_ppm"])[1]

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, pj))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss_grads(pj, b, tokens, dtype, monkeypatch):
    """The port's training forward + ``loss_smoothed`` and its gradients,
    with the calls of the gathered route's plain functions counted."""
    calls = {}
    for name in ("message_mlp_plain", "message_mlp_bwd_plain"):
        fn = getattr(mk, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mk, name, counted)
    pt = from_jax_params(pj, device="cpu", dtype=dtype)
    leaves = list(tree_leaves(pt))
    for leaf in leaves:
        leaf.requires_grad_(True)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    lp, _ = forward(pt, ModelConfig(dropout=0.0), bt)
    mfl = losses.mask_for_loss(bt["S"], bt["mask"]).to(lp.dtype)
    pm = {k: bt[f"{k}_mask"] for k in ("protein", "dna", "rna")}
    _, loss = losses.loss_smoothed(
        bt["S"], lp, mfl, pm, losses.make_polymer_restype_masks(True),
        weight=0.1, tokens=tokens, num_letters=33, ppm_mask=bt["ppm_mask"],
        aligned_ppm=bt["aligned_ppm"])
    loss.backward()
    assert calls == {"message_mlp_plain": 3, "message_mlp_bwd_plain": 3}
    return float(loss.detach()), [leaf.grad for leaf in leaves]


def test_gathered_route_loss_and_gradients_float64_full_width(monkeypatch):
    b = _case_b2_l50(np.float64)
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", dropout=0.0)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(2), cfg_j))
        loss_j, grads_j = _jax_loss_grads(cfg_j, pj, b, 150.0)
    loss, grads = _port_loss_grads(pj, b, 150.0, torch.float64, monkeypatch)
    assert abs(loss - loss_j) < ATOL
    assert len(grads) == len(grads_j) > 100
    for i, (g, g_j) in enumerate(zip(grads, grads_j)):
        assert g is not None, i
        np.testing.assert_allclose(g.numpy(), g_j, atol=ATOL, rtol=0,
                                   err_msg=f"leaf {i}")


def test_gathered_route_against_pallas_interpret_fp32(monkeypatch):
    monkeypatch.setattr(jax_ops, "INTERPRET", True)
    b = _case_b2_l50(np.float32)
    cfg_j = JaxConfig(kernels="pallas", compute_dtype="float32", dropout=0.0)
    pj = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(2), cfg_j))
    loss_j, grads_j = _jax_loss_grads(cfg_j, pj, b, 150.0)
    loss, grads = _port_loss_grads(pj, b, 150.0, torch.float32, monkeypatch)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    assert len(grads) == len(grads_j) > 100
    for i, (g, g_j) in enumerate(zip(grads, grads_j)):
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(g.numpy(), g_j, atol=1e-4 * scale + 1e-12,
                                   rtol=0, err_msg=f"leaf {i}")

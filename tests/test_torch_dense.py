"""``rbf_mode="dense"`` on one device (plain path, CPU, float64): the port's
``encode``, ``score``, ``sample`` and training forward with its gradients
against the JAX package's XLA path under ``jax.enable_x64``, to 1e-8 (the
bar of ``test_torch_model64.py``); the mode is set only through
``ModelConfig``. The JAX XLA path computes ``all_pair_rbf(...) @ W`` in
either mode, which is the function the dense kernel computes."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import encode as jax_encode
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models import sample as jax_sample
from na_mpnn_tpu.models import score as jax_score

from na_mpnn_tpu_torch.models import ModelConfig, encode, forward, sample, score
from na_mpnn_tpu_torch.models.config import check_supported
from na_mpnn_tpu_torch.params import from_jax_params
from na_mpnn_tpu_torch.train import collate
from na_mpnn_tpu_torch.train.trainer import Trainer, tree_leaves
from ref_oracle import make_synthetic_structure

ATOL = 1e-8
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
             dropout=0.0)
DENSE = ModelConfig(rbf_mode="dense", **SMALL)


@pytest.fixture(scope="module")
def case():
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", rbf_mode="dense", **SMALL)
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(1), cfg_j))
    b = make_synthetic_structure(L=48, seed=6, n_protein=20, n_dna=16)
    b["chain_mask"] = np.ones_like(b["mask"])
    b["chain_mask"][0, :5] = 0
    b["X"] = b["X"].astype(np.float64)
    pt = from_jax_params(pj, device="cpu", dtype=torch.float64)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    return cfg_j, pj, b, pt, bt


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_dense_encode_and_score_float64(case):
    cfg_j, pj, b, pt, bt = case
    order = np.random.RandomState(3).permutation(48)[None]
    with jax.enable_x64(True):
        pjj = jax.tree.map(jnp.asarray, pj)
        hv_j, he_j, e_j = map(np.asarray, jax_encode(pjj, cfg_j, _jb(b)))
        lp_j = np.asarray(jax_score(pjj, cfg_j, _jb(b),
                                    decoding_order=jnp.asarray(order))["log_probs"])
    hv, he, e = encode(pt, DENSE, bt)
    np.testing.assert_array_equal(e.numpy(), e_j)
    np.testing.assert_allclose(hv.numpy(), hv_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(he.numpy(), he_j, atol=ATOL, rtol=0)
    lp = score(pt, DENSE, bt, decoding_order=torch.from_numpy(order))["log_probs"]
    np.testing.assert_allclose(lp.numpy(), lp_j, atol=ATOL, rtol=0)


def test_dense_sample_float64_token_exact(case):
    cfg_j, pj, b, pt, bt = case
    B, L, nl, T = 2, 48, 33, 0.5
    rng = np.random.RandomState(8)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.split(key)[1], L)
        gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, nl), jnp.float64))
                           for k in keys])
        out_j = jax_sample(jax.tree.map(jnp.asarray, pj), cfg_j,
                           {**_jb(b), "decoding_order": jnp.asarray(order)}, key,
                           num_samples=B, temperature=T)
        out_j = {k: np.asarray(v) for k, v in out_j.items()}
    out = sample(pt, DENSE, {**bt, "decoding_order": torch.from_numpy(order)},
                 None, num_samples=B, temperature=T,
                 gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out["S"].numpy(), out_j["S"])
    np.testing.assert_allclose(out["log_probs"].numpy(), out_j["log_probs"],
                               atol=ATOL, rtol=0)


def test_dense_training_forward_and_gradients_float64(case):
    """log-probs of the training forward and the gradient of every
    parameter of a scalar of them, through the dense RBF autograd Function
    and the message-table Functions."""
    cfg_j, pj, b, pt, bt = case
    rng = np.random.RandomState(4)
    order = rng.permutation(48)[None]
    R = rng.randn(1, 48, 33)
    with jax.enable_x64(True):
        bj = {**_jb(b), "decoding_order": jnp.asarray(order)}

        def f(params):
            return jnp.sum(jax_forward(params, cfg_j, bj)[0] * R)

        val_j, grads_j = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, pj))
        grads_j = [np.asarray(g) for g in jax.tree.leaves(grads_j)]
    leaves = list(tree_leaves(pt))
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = None
    lp, _ = forward(pt, DENSE, {**bt, "decoding_order": torch.from_numpy(order)})
    val = (lp * torch.from_numpy(R)).sum()
    val.backward()
    assert abs(float(val.detach()) - float(val_j)) < ATOL * max(1.0, abs(float(val_j)))
    assert len(leaves) == len(grads_j)
    # the gradient reaches the RBF rows of the edge projection
    assert float(pt["features"]["edge_embedding"]["w"].grad[16:].abs().max()) > 0
    for i, (leaf, g) in enumerate(zip(leaves, grads_j)):
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=ATOL, rtol=0,
                                   err_msg=f"leaf {i}")
        leaf.requires_grad_(False)
        leaf.grad = None


def test_dense_trainer_step_equals_classed_on_the_cpu():
    """The Trainer takes the mode from its ModelConfig. On the CPU both
    modes run the plain ``all_pair_rbf @ W``, so one step agrees."""
    structs = []
    for L, seed in ((40, 1), (52, 2)):
        s = make_synthetic_structure(L=L, seed=seed, n_protein=16, n_dna=16)
        structs.append({k: v[0] for k, v in s.items()})
    nb = collate.collate_batch(structs)
    cfg = ModelConfig(**{**SMALL, "dropout": 0.1, "protein_augment_eps": 0.1})
    flats = []
    for mode in ("classed", "dense"):
        tr = Trainer(dataclasses.replace(cfg, rbf_mode=mode), seed=0, device="cpu")
        tr.train_step(nb, torch.Generator().manual_seed(3))
        flats.append(tr.flat)
    assert torch.allclose(flats[0], flats[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="rbf_mode"):
        check_supported(ModelConfig(rbf_mode="sparse"))

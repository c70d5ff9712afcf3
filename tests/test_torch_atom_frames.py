"""The two atom frames the RBF kernels do not take (``models/features.py``:
``include_pred_na_N=False``, 17 slots; ``atom_table="all"``, the 65-atom
table, 67 slots), whose RBF block runs through ``PairRbfProjection`` (the
plain all-pair RBF and one product, as the JAX featurisers compute it
outside any Pallas kernel), against the JAX package with
``kernels="xla"``.

* float64: the ``forward`` log-probs under a given decode order, and one
  ``Trainer`` step's loss (``loss_smoothed``) and the gradient of every
  parameter, within 1e-8 (the bar of ``test_torch_model64.py``).
* bf16 (``compute_dtype="bfloat16"``, fp32 parameters): the same step
  against JAX's bf16 step, with ``test_torch_bf16_train.py``'s bars: the
  loss within 1e-3 relative, each gradient leaf within 3e-2 of its largest
  entry plus the JAX bf16 gradient's own distance from its fp32 gradient.
  At bf16 both packages form the RBF product in fp32 and add the bf16
  positional block to it.
* ``PairRbfProjection`` in row blocks (5, and a block larger than L) gives
  the one-block output and weight gradient at float64, and its backward
  recomputes the block (it saves no RBF).
Batch: B = 2, L = 24, H = 32, K = 8, 2 + 2 layers, dropout and noise off;
the 65-atom batch carries side-chain atoms of its own besides the
backbone."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu import constants as jconst
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train import losses as jax_losses

from na_mpnn_tpu_torch.models import ModelConfig, forward
from na_mpnn_tpu_torch.models import features
from na_mpnn_tpu_torch.params import from_jax_params
from na_mpnn_tpu_torch.train.trainer import Trainer
from ref_oracle import make_synthetic_structure

ATOL = 1e-8
B, L = 2, 24
TOKENS = 100.0
SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=8,
             dropout=0.0)
FRAMES = {"no_na_N": dict(include_pred_na_N=False),
          "all_atoms": dict(atom_table="all")}


def _batch(frame):
    rng = np.random.RandomState(7)
    parts = [make_synthetic_structure(L=L, seed=61 + i, n_protein=12, n_dna=8)
             for i in range(B)]
    b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if frame == "all_atoms":
        X = np.zeros((B, L, jconst.NUM_ALL_ATOMS, 3), np.float32)
        X_m = np.zeros((B, L, jconst.NUM_ALL_ATOMS), np.int32)
        for a, i in jconst.ATOM_DICT.items():
            X[:, :, jconst.ALL_ATOM_ORDER[a]] = b["X"][:, :, i]
            X_m[:, :, jconst.ALL_ATOM_ORDER[a]] = b["X_m"][:, :, i]
        centre = b["X"][:, :, jconst.ATOM_DICT["CA"]] + b["X"][:, :, jconst.ATOM_DICT["C1'"]]
        for a in ("CB", "CG", "OD1", "N9", "C8", "O6"):
            j = jconst.ALL_ATOM_ORDER[a]
            X[:, :, j] = centre + rng.randn(B, L, 3) * 1.5
            X_m[:, :, j] = rng.rand(B, L) > 0.3
        b["X"], b["X_m"] = X, X_m
    b["aligned_ppm"] = np.zeros((B, L, 33), np.float32)
    b["aligned_ppm"][..., 21:25] = rng.dirichlet(np.ones(4), size=(B, L))
    b["ppm_mask"] = (b["dna_mask"] * (rng.rand(B, L) > 0.3)).astype(np.int32)
    b["canonical_base_pair_mask"] = np.zeros((B, L), np.int32)
    b["canonical_base_pair_index"] = np.tile(np.arange(L), (B, 1))
    b["mask"][1, -3:] = 0
    order = np.stack([rng.permutation(L) for _ in range(B)])
    return b, order


def _jax_step(cfg_j, params, b, order):
    """JAX's loss (``loss_smoothed``), its gradients and the log-probs."""
    def loss(p):
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        bj["decoding_order"] = jnp.asarray(order)
        lp, _ = jax_forward(p, cfg_j, bj, deterministic=False)
        mfl = jax_losses.mask_for_loss(bj["S"], bj["mask"]).astype(lp.dtype)
        pm = {k: bj[f"{k}_mask"] for k in ("protein", "dna", "rna")}
        return jax_losses.loss_smoothed(
            bj["S"], lp, mfl, pm, jax_losses.make_polymer_restype_masks(True),
            weight=0.1, tokens=TOKENS, num_letters=33, ppm_mask=bj["ppm_mask"],
            aligned_ppm=bj["aligned_ppm"])[1], lp

    (value, lp), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return float(value), [np.asarray(g).reshape(-1) for g in jax.tree.leaves(grads)], \
        np.asarray(lp)


def _port_step(cfg, params, b, order, dtype):
    tr = Trainer(cfg, device="cpu", loss_tokens=TOKENS, dtype=dtype)
    with torch.no_grad():
        for leaf, a in zip(tr.leaves, jax.tree.leaves(params)):
            leaf.copy_(torch.from_numpy(np.array(a)))
    batch = tr.device_batch(b)
    batch["decoding_order"] = torch.from_numpy(order)
    loss, grad = tr.loss_and_grads(batch)[:2]
    parts, off = [], 0
    for leaf in tr.leaves:
        parts.append(grad[off:off + leaf.numel()].numpy())
        off += leaf.numel()
    return float(loss), parts, batch


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_atom_frame_float64_matches_jax(frame):
    b, order = _batch(frame)
    b["X"] = b["X"].astype(np.float64)
    with jax.enable_x64(True):
        cfg_j = JaxConfig(kernels="xla", **SMALL, **FRAMES[frame])
        pj = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_init(jax.random.PRNGKey(4), cfg_j))
        loss_j, grads_j, lp_j = _jax_step(cfg_j, pj, b, order)
    cfg = ModelConfig(**SMALL, **FRAMES[frame])
    assert cfg.edge_in == cfg_j.edge_in
    loss, grads, batch = _port_step(cfg, pj, b, order, torch.float64)
    with torch.no_grad():
        lp = forward(from_jax_params(pj, device="cpu", dtype=torch.float64), cfg,
                     batch)[0]
    np.testing.assert_allclose(lp.numpy(), lp_j, atol=ATOL, rtol=0)
    assert abs(loss - loss_j) <= ATOL
    assert len(grads) == len(grads_j)
    for i, (g, g_j) in enumerate(zip(grads, grads_j)):
        np.testing.assert_allclose(g, g_j, atol=ATOL, rtol=0, err_msg=str(i))
    assert max(float(np.abs(g).max()) for g in grads_j) > 1e-3


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_atom_frame_bf16_matches_jax(frame):
    b, order = _batch(frame)
    cfg_j = JaxConfig(kernels="xla", **SMALL, **FRAMES[frame])
    pj = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4), cfg_j))
    loss_j, grads_j, _ = _jax_step(
        JaxConfig(kernels="xla", compute_dtype="bfloat16", **SMALL, **FRAMES[frame]),
        pj, b, order)
    _, grads_j32, _ = _jax_step(cfg_j, pj, b, order)
    loss, grads, _ = _port_step(ModelConfig(compute_dtype="bfloat16", **SMALL,
                                            **FRAMES[frame]),
                                pj, b, order, torch.float32)
    assert abs(loss - loss_j) <= 1e-3 * abs(loss_j)
    for i, (g, g_j, g32) in enumerate(zip(grads, grads_j, grads_j32)):
        tol = 3e-2 * float(np.abs(g_j).max()) + float(np.abs(g_j - g32).max())
        assert float(np.abs(g - g_j).max()) <= tol + 1e-12, i


def test_row_blocks_give_the_one_block_projection(monkeypatch):
    b, _ = _batch("all_atoms")
    cfg = ModelConfig(**SMALL, **FRAMES["all_atoms"])
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    X = bt["X"].double()
    X_aug, X_m_aug, X_ref = features.build_augmented_atoms(X, bt["X_m"], bt, cfg)
    assert X_aug.shape[2] == cfg.total_atoms == 67
    E_idx = features.knn_graph(X_ref, bt["mask"].double(), 8)[1]
    W = torch.randn(cfg.num_rbf * 67 ** 2, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    g = torch.randn(B, L, 8, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    calls = {"n": 0}
    rbf = features.all_pair_rbf

    def counted(*a, **kw):
        calls["n"] += 1
        return rbf(*a, **kw)
    monkeypatch.setattr(features, "all_pair_rbf", counted)
    outs = []
    for chunk in (0, 5, 100):
        calls["n"] = 0
        out = features.PairRbfProjection.apply(X_aug, X_m_aug, X_aug, X_m_aug,
                                               E_idx, W, cfg.num_rbf, chunk)
        (dW,) = torch.autograd.grad((out * g).sum(), W)
        blocks = -(-L // chunk) if 0 < chunk < L else 1
        assert calls["n"] == 2 * blocks
        outs.append((out.detach(), dW))
    want = (features.all_pair_rbf(X_aug, E_idx, X_m_aug, cfg.num_rbf) @ W).detach()
    for out, dW in outs:
        torch.testing.assert_close(out, want, atol=1e-12, rtol=0)
        torch.testing.assert_close(dW, outs[0][1], atol=1e-12, rtol=0)

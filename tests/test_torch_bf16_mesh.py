"""The bf16 trunk (``MIXED_PRECISION: 1``) on gloo meshes of CPU processes.

The port follows the JAX Trainer's dtype policy on each mesh shape:
* G = 1 (JAX: the data-parallel ``forward``, ``trainer.py:111-112``,
  ``:160-161``): the whole one-device bf16 trunk. A (2,1) step (dropout and
  noise off, decode order given; H=32, K=16, 2+2 layers; B=2, L=64, so the
  one-device decoder takes the table route as the mesh's does) against the
  one-device bf16 step on the whole batch: the loss within 1e-4 relative,
  each gradient leaf within one bf16 step (2^-7) of its largest entry,
  because each rank rounds its partial weight gradient to bf16 (the
  gradients of the bf16 layer parameters) before the fp32 all-reduce.
* G > 1 (JAX ``forward_graph_parallel``, ``_forward_local``): only the RBF
  projection is bf16; the positional block and both layer stacks run in
  fp32. A (1,2) bf16 step against the port's (1,2) fp32 step: the loss
  within 1e-3 relative, each gradient leaf within 3e-2 of its largest entry
  (the bars of ``test_torch_bf16_train.py``). On a rank of the (1,2) mesh
  the RBF projection equals the one-device bf16 projection
  (``rbf_edge_features_classed(low=True)``, and the dense bf16 one) on the
  rank's residues up to the order of the fp32 sums (1e-6), and the edge
  features equal the one-device featuriser's with an fp32 positional block
  (1e-5), not a bf16 one.
* The (1,2) mesh's deterministic bf16 forward against JAX
  ``forward_graph_parallel`` at bf16 (jitted, the Pallas kernels in
  interpret mode, on a one-device mesh: the function it computes does not
  depend on the mesh shape) on the same parameters and decode order, in
  both RBF modes: the log-probs within 5e-4, because the bf16 RBF rows
  agree only to 2^-8 of their largest value (a bin near a bf16 rounding
  boundary rounds apart) and the fp32 layers sum in other orders; and at
  least three times nearer JAX than the port's fp32 forward, so the bf16
  rounding of the RBF shows.
* ``run_training`` from a config without ``MIXED_PRECISION`` on a world of 2
  gloo ranks.

The ranks run ``test_torch_mesh_workers.py`` in their own processes; the
JAX reference runs here."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import na_mpnn_tpu.ops as jax_ops
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu_torch.models import ModelConfig
from na_mpnn_tpu_torch.models.features import (build_augmented_atoms,
                                               features_from_coords)
from na_mpnn_tpu_torch.ops import rbf_classed, rbf_edge
from na_mpnn_tpu_torch.params import from_jax_params
from na_mpnn_tpu_torch.train.trainer import Trainer, to_device
from test_torch_mesh_train import _batch
import test_torch_mesh_workers as workers
from test_torch_mesh_workers import spawn

CFG = dict(node_features=32, edge_features=32, hidden_dim=32,
           num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
           dropout=0.0)
BF16 = dict(CFG, compute_dtype="bfloat16")
TRAINER = dict(loss_tokens=100.0, seed=0)
SEED = 0
MODES = ("classed", "dense")


def _ordered_batch():
    nb = {k: v for k, v in _batch().items() if np.asarray(v).dtype.kind in "biuf"}
    rng = np.random.RandomState(4)
    nb["decoding_order"] = np.stack([rng.permutation(64) for _ in range(2)])
    return nb


def _rel(a, b):
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-30)


def _leaves(flat, offsets):
    return [flat[a:b] for a, b in zip(offsets[:-1], offsets[1:])]


def _one_device(nb, cfg_kw):
    tr = Trainer(ModelConfig(**cfg_kw), device="cpu", **TRAINER)
    batch = tr.device_batch(nb)
    batch["decoding_order"] = torch.from_numpy(nb["decoding_order"])
    loss, grad = tr.loss_and_grads(batch)[:2]
    offsets = np.cumsum([0] + [p.numel() for p in tr.leaves])
    return float(loss), grad.numpy(), offsets


def test_bf16_mesh_data_axis_runs_the_trunk_and_matches_one_device(tmp_path):
    nb = _ordered_batch()
    loss_1, grad_1, offsets = _one_device(nb, BF16)
    res = spawn(workers.mesh_steps, 2, tmp_path / "store", (2, 1, nb, [BF16], TRAINER))
    for (loss, grad, dtypes), in res:
        assert dtypes == [("dec_layer", "torch.bfloat16"), ("enc_layer", "torch.bfloat16")]
        assert abs(loss - loss_1) <= 1e-4 * abs(loss_1)
        for i, (g, g1) in enumerate(zip(_leaves(grad, offsets), _leaves(grad_1, offsets))):
            assert float(np.abs(g - g1).max()) <= 2.0 ** -7 * float(np.abs(g1).max()) + 1e-12, i
    assert np.abs(grad_1).max() > 1e-4


def _jax_graph_forward(params_np, nb, mode):
    """JAX ``forward_graph_parallel`` at bf16, jitted, the Pallas kernels in
    interpret mode, on a one-device mesh: what it computes does not depend
    on the mesh shape (only the RBF in bf16 at any shape), so this is the
    function the JAX Trainer runs at G > 1."""
    from na_mpnn_tpu.parallel.graph_parallel import forward_graph_parallel as jax_gp
    from na_mpnn_tpu.parallel.mesh import make_mesh as jax_mesh

    cfg = JaxConfig(kernels="pallas", **dict(BF16, rbf_mode=mode))
    mesh = jax_mesh(n_devices=1)
    keys = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
            "dna_mask", "rna_mask", "R_polymer_type")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ops, "INTERPRET", True)
        lp = jax.jit(lambda p, b, o: jax_gp(p, cfg, b, mesh, decoding_order=o))(
            jax.tree.map(jnp.asarray, params_np),
            {k: jnp.asarray(nb[k]) for k in keys}, jnp.asarray(nb["decoding_order"]))
    return np.asarray(lp)


@pytest.fixture(scope="module")
def graph_mesh(tmp_path_factory):
    """The (1,2) mesh's bf16 and fp32 steps; per RBF mode its deterministic
    bf16 and fp32 forwards on each rank (the log-probs, and the features
    inside them) on the parameters of a JAX ``init_params``; and JAX
    ``forward_graph_parallel`` at bf16 on the same parameters."""
    path = tmp_path_factory.mktemp("graph_mesh")
    nb = _ordered_batch()
    params_np = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(SEED),
                                                  JaxConfig(**BF16)))
    steps = spawn(workers.mesh_steps, 2, path / "steps",
                  (1, 2, nb, [BF16, CFG], TRAINER))
    feats = spawn(workers.mesh_features, 2, path / "feats",
                  (1, 2, nb, nb["decoding_order"],
                   [dict(c, rbf_mode=m) for m in MODES for c in (BF16, CFG)],
                   params_np))
    jax_lp = {m: _jax_graph_forward(params_np, nb, m) for m in MODES}
    return nb, params_np, steps, feats, jax_lp


def test_bf16_mesh_graph_axis_keeps_fp32_layers(graph_mesh):
    nb, _, steps, _, _ = graph_mesh
    offsets = _one_device(nb, CFG)[2]
    for (loss, grad, dtypes), (loss32, grad32, dtypes32) in steps:
        assert dtypes == dtypes32 == [("dec_layer", "torch.float32"),
                                      ("enc_layer", "torch.float32")]
        assert loss != loss32
        assert abs(loss - loss32) <= 1e-3 * abs(loss32)
        for i, (g, g32) in enumerate(zip(_leaves(grad, offsets), _leaves(grad32, offsets))):
            assert float(np.abs(g - g32).max()) <= 3e-2 * float(np.abs(g32).max()) + 1e-12, i


@pytest.mark.parametrize("mode", MODES)
def test_bf16_mesh_graph_axis_forward_matches_jax(graph_mesh, mode):
    """The port's deterministic (1,2) forward at bf16 against JAX
    ``forward_graph_parallel`` at bf16 on the same parameters and decode
    order."""
    _, _, _, feats, jax_lp = graph_mesh
    i = 2 * MODES.index(mode)
    lp, lp32 = (np.concatenate([ranks[j]["lp"] for ranks in feats], axis=1)
                for j in (i, i + 1))
    err = float(np.abs(lp - jax_lp[mode]).max())
    assert err < 5e-4
    # the bf16 RBF shows: the port's fp32 forward is three times as far
    assert err < float(np.abs(lp32 - jax_lp[mode]).max()) / 3


@pytest.mark.parametrize("mode", MODES)
def test_bf16_mesh_graph_axis_features(graph_mesh, mode):
    """A rank's bf16 RBF rows and fp32-positional edge features equal the
    one-device pieces on the rank's residues."""
    nb, params_np, _, feats, _ = graph_mesh
    cfg = ModelConfig(**dict(BF16, rbf_mode=mode))
    params = from_jax_params(params_np, device="cpu")
    batch = to_device(nb, "cpu")
    with torch.no_grad():
        _, E32, E_idx, _ = features_from_coords(params["features"], cfg, batch,
                                                batch["X"], low_pos=False)
        E16 = features_from_coords(params["features"], cfg, batch, batch["X"])[1]
        X_aug, X_m_aug, _ = build_augmented_atoms(batch["X"], batch["X_m"], batch, cfg)
        W = params["features"]["edge_embedding"]["w"][cfg.num_positional_embeddings:]
        fn = (rbf_edge.rbf_edge_features if cfg.rbf_mode == "dense"
              else rbf_classed.rbf_edge_features_classed)
        rbf = fn(X_aug, X_m_aug, E_idx, W, low=True)
        rbf32 = fn(X_aug, X_m_aug, E_idx, W)
    Ls = 32
    for g, ranks in enumerate(feats):
        seen = ranks[2 * MODES.index(mode)]
        rows = slice(g * Ls, (g + 1) * Ls)
        assert seen["low"] is True and seen["low_pos"] is False
        np.testing.assert_array_equal(seen["E_idx"], E_idx[:, rows].numpy())
        assert _rel(seen["rbf"], rbf[:, rows].numpy()) < 1e-6
        assert _rel(seen["rbf"], rbf32[:, rows].numpy()) > 1e-5
        assert _rel(seen["E"], E32[:, rows].numpy()) < 1e-5
        assert _rel(seen["E"], E16[:, rows].numpy()) > 1e-4


def test_run_training_defaults_to_bf16_on_a_mesh(tmp_path):
    """A config without ``MIXED_PRECISION`` trains the bf16 trunk on a
    (2,1) gloo mesh: every rank takes the same steps, rank 0 logs a finite
    loss and writes the fp32 checkpoint."""
    import json

    csv_path = chip_smoke.write_training_set(str(tmp_path / "ds"), [
        (("A", "protein", 14 + 4 * i), ("B", "dna", 8), ("C", "dna", 8))
        for i in range(3)], seed=9)
    cfg = chip_smoke.training_config(
        csv_path, str(tmp_path / "run"), HIDDEN_DIM=32, NUM_NEIGHBORS=8,
        NUM_ENCODER_LAYERS=1, NUM_DECODER_LAYERS=1, BATCH_TOKENS=100,
        LOSS_TOKENS=100)
    del cfg["MIXED_PRECISION"]
    res = spawn(workers.run_training_dtype_rank, 2, tmp_path / "store", (cfg,))
    assert len(set(res)) == 1 and res[0][0] >= 1 and res[0][1] == "bfloat16"
    with open(tmp_path / "run" / "log.jsonl") as f:
        log = json.loads(f.readline())
    assert np.isfinite(log["train_loss"])
    with np.load(tmp_path / "run" / "last.npz") as z:
        assert all(z[k].dtype == np.float32 for k in z.files
                   if np.issubdtype(z[k].dtype, np.floating))

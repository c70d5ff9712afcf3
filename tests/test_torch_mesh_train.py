"""The port's mesh ``Trainer`` on gloo meshes of CPU processes.

* Partition invariance: with dropout 0.1 and 0.1 A noise (row-keyed
  streams) one training loss and its flat gradient at meshes (1,2), (1,4),
  (2,1) and (2,2) equal those at (1,1) within 1e-12 relative at float64:
  only the order of the sums differs.
* One ``train_step`` (fp32) at (2,1) and (1,2) equals the step at (1,1) on
  the whole batch: the flat gradient within 1e-5 of its max, the parameters
  after the step within 1e-5 of each leaf's max (Adam's first step is close
  to ``lr * sign(g)``, so a tighter bar would fail on gradients that are
  nearly zero), the metrics of the global batch alike; ``save`` on rank 0
  then ``restore`` on every rank is bitwise; ``sync_batch_length`` pads
  every rank's batch to the longest over the world.

The ranks run ``test_torch_mesh_workers.py`` in their own processes."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest

from na_mpnn_tpu_torch.train import collate
from ref_oracle import make_synthetic_structure
import test_torch_mesh_workers as workers
from test_torch_mesh_workers import spawn

CFG = dict(node_features=32, edge_features=32, hidden_dim=32,
           num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
           dropout=0.1, protein_augment_eps=0.1, dna_augment_eps=0.1,
           rna_augment_eps=0.1)
TRAINER = dict(loss_tokens=100.0, seed=0)


def _batch():
    """Two structures collated to B=2, L=64, with canonical base pairs whose
    partners sit in other graph shards, and a PPM."""
    structs = []
    for L, seed in ((60, 21), (64, 22)):
        b = make_synthetic_structure(L=L, seed=seed, n_protein=24, n_dna=24)
        structs.append({k: v[0] for k, v in b.items()})
    rng = np.random.RandomState(0)
    for s in structs:
        L = s["S"].shape[0]
        s["canonical_base_pair_mask"] = (s["dna_mask"] * (rng.rand(L) > 0.3)).astype(np.int32)
        s["canonical_base_pair_index"] = rng.permutation(L).astype(np.int64)
        s["ppm_mask"] = (s["dna_mask"] * (rng.rand(L) > 0.5)).astype(np.int32)
        ppm = np.zeros((L, 33))
        ppm[:, 21:25] = rng.dirichlet(np.ones(4), size=L)
        s["aligned_ppm"] = ppm
    nb = collate.collate_batch(structs)
    assert nb["S"].shape == (2, 64)
    return nb


def _run(fn, data, graph, path, *args):
    return spawn(fn, data * graph, path, (data, graph, *args))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    path = tmp_path_factory.mktemp("one_rank")
    nb = _batch()
    loss, grad = _run(workers.trainer_loss_and_grads, 1, 1, path / "store64",
                      nb, CFG, TRAINER)[0]
    step = _run(workers.trainer_step, 1, 1, path / "store32", nb, CFG, TRAINER,
                str(path / "ckpt.npz"))[0]
    return nb, loss, grad, step


@pytest.mark.parametrize("data,graph", [(1, 2), (1, 4), (2, 1), (2, 2)])
def test_training_loss_and_gradient_do_not_depend_on_the_mesh(
        one_rank, tmp_path, data, graph):
    nb, loss_1, grad_1, _ = one_rank
    res = _run(workers.trainer_loss_and_grads, data, graph, tmp_path / "store",
               nb, CFG, TRAINER)
    for loss, grad in res:
        assert abs(loss - loss_1) <= 1e-12 * abs(loss_1)
        assert np.abs(grad - grad_1).max() <= 1e-12 * np.abs(grad_1).max()
    assert np.abs(grad_1).max() > 1e-4


@pytest.mark.parametrize("data,graph", [(2, 1), (1, 2)])
def test_mesh_trainer_step_matches_one_rank(one_rank, tmp_path, data, graph):
    nb, _, _, ref = one_rank
    res = _run(workers.trainer_step, data, graph, tmp_path / "store", nb, CFG,
               TRAINER, str(tmp_path / "ckpt.npz"))
    flat0 = ref["flat"]
    offsets = ref["offsets"]
    for out in res:
        assert out["restored"] and out["synced"]
        g, g_ref = out["grad"], ref["grad"]
        assert np.abs(g - g_ref).max() <= 1e-5 * np.abs(g_ref).max()
        for a, b in zip(offsets[:-1], offsets[1:]):
            tol = 1e-5 * np.abs(flat0[a:b]).max()
            assert np.abs(out["flat"][a:b] - flat0[a:b]).max() <= tol, (a, b)
        m, m_ref = out["metrics"], ref["metrics"]
        assert sorted(m) == sorted(m_ref)
        assert abs(float(m["loss_av"]) - float(m_ref["loss_av"])) <= \
            1e-5 * abs(float(m_ref["loss_av"]))
        for k in ("S_pred", "accuracy", "cbp_accuracy", "mask_for_loss"):
            assert m[k].shape == (2, 64), k
            np.testing.assert_array_equal(m[k], m_ref[k], err_msg=k)
        np.testing.assert_allclose(m["loss_per_token"], m_ref["loss_per_token"],
                                   rtol=1e-5, atol=1e-6)
    assert ref["metrics"]["cbp_accuracy"].shape == (2, 64)

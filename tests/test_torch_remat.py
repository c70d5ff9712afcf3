"""Per-layer rematerialisation (``ModelConfig.remat``, any value but
``"none"``; ``models/mpnn.py::_remat_tail``) on the CPU: one training
step's loss and its whole flat gradient are bitwise those of
``remat="none"`` from the same generator seed, with dropout 0.1 and
coordinate noise on, at fp32 and bf16, on the table route (L = 32) and the
gathered decoder route (L = 40), with the kernel wrappers and with
``kernels="torch"`` (under ``torch.use_deterministic_algorithms``: the
CPU's index backward of the plain message functions otherwise adds in a
varying order, remat or not); the layers' tails really run again in the backward
(the FFN runs twice per layer with remat, once without); and on a one-rank
gloo mesh (G = 1, the mesh's row-keyed dropout) the same holds."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

from na_mpnn_tpu_torch.models import ModelConfig
from na_mpnn_tpu_torch.models import mpnn
from na_mpnn_tpu_torch.train.collate import collate_batch
from na_mpnn_tpu_torch.train.trainer import Trainer
from ref_oracle import make_synthetic_structure
import test_torch_mesh_workers as workers
from test_torch_mesh_workers import spawn

CFG = dict(node_features=32, edge_features=32, hidden_dim=32,
           num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16,
           dropout=0.1, protein_augment_eps=0.1, dna_augment_eps=0.1,
           rna_augment_eps=0.1)


def _batch(L):
    parts = [{k: v[0] for k, v in make_synthetic_structure(
        L=L - 4 * i, seed=31 + i, n_protein=16, n_dna=10).items()} for i in range(2)]
    return collate_batch(parts, pad_to=L)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _step(cfg, nb, calls):
    """One step's loss, flat gradient and the FFN's calls."""
    tr = Trainer(cfg, device="cpu", loss_tokens=100.0)
    calls["pff"] = 0
    loss, grad = tr.loss_and_grads(tr.device_batch(nb),
                                   torch.Generator().manual_seed(5))[:2]
    return loss, grad, calls["pff"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [32, 40], ids=["table", "gathered"])
@pytest.mark.parametrize("kernels", ["auto", "torch"])
def test_remat_step_is_bitwise_none(monkeypatch, deterministic, dtype, L, kernels):
    calls = {"pff": 0}
    pff = mpnn.pff_apply

    def counted(*a, **kw):
        calls["pff"] += 1
        return pff(*a, **kw)
    monkeypatch.setattr(mpnn, "pff_apply", counted)
    nb = _batch(L)
    base = ModelConfig(**CFG, compute_dtype=dtype, kernels=kernels)
    loss0, grad0, n0 = _step(base, nb, calls)
    loss1, grad1, n1 = _step(dataclasses.replace(base, remat="layer"), nb, calls)
    n_layers = CFG["num_encoder_layers"] + CFG["num_decoder_layers"]
    assert (n0, n1) == (n_layers, 2 * n_layers)
    assert torch.equal(loss0, loss1)
    assert torch.equal(grad0, grad1)
    assert float(grad0.abs().max()) > 0


def test_remat_on_a_one_rank_mesh_is_bitwise_none(tmp_path):
    nb = _batch(32)
    res = spawn(workers.mesh_steps, 1, tmp_path / "store",
                (1, 1, nb, [dict(CFG), dict(CFG, remat="layer")],
                 dict(loss_tokens=100.0, seed=0)))[0]
    (loss0, grad0, _), (loss1, grad1, _) = res
    assert loss0 == loss1 and np.isfinite(loss0)
    np.testing.assert_array_equal(grad0, grad1)

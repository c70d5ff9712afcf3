"""The LigandMPNN training cell: a CPU rehearsal at a small size, its
control and faults, the traffic and the cost counts."""
import pytest

from port_bench import costs, costs_ligand, faults_context, run, traffic, traffic_ligand
from port_bench.tests import small_context as S

@pytest.fixture
def unpatched():
    from na_mpnn_tpu_torch.models import ligand, mpnn
    from na_mpnn_tpu_torch.train import optimizer, trainer
    saved = [(ligand, "context_layer", ligand.context_layer),
             (mpnn, "sample", mpnn.sample), (mpnn, "score", mpnn.score),
             (trainer.Trainer, "loss_and_grads", trainer.Trainer.loss_and_grads),
             (optimizer.NoamAdam, "update", optimizer.NoamAdam.update)]
    yield
    for owner, name, value in saved:
        setattr(owner, name, value)


def test_ligand_cpu_rehearsal_and_control():
    """ligand.train end to end on the CPU, traced: correct, its per-layer
    metrics read, a dense 625 rows a residue over the padded share, and
    the fp8 control fails a number."""
    result, checks, extra = run.run_cell("ligand.train", 2 ** 31 + 5, 0.5, True,
                                         device="cpu", overrides=S.LIGAND,
                                         controls=("fp8",))
    assert result["correct"], checks
    metrics = result["metrics"]
    for name in ("context_fwd_ms.ligand_train", "context_rows_per_token.ligand_train",
                 "context_roofline.ligand_train", "mfu.ligand_train", "fwd_bwd_ms.train"):
        assert name in metrics, name
    assert metrics["context_rows_per_token.ligand_train"]["value"] >= 625
    limits = {k: lim for k, _, lim in checks}
    assert any(extra["fp8"][k] > limits[k] for k in limits), extra


@pytest.mark.parametrize("fault", ["atom_graph", "half", "frozen"])
def test_ligand_faults_fail(fault, unpatched):
    result, checks, _ = run.run_cell("ligand.train", 23, 0.2, False, device="cpu",
                                     overrides=S.LIGAND,
                                     plant=faults_context.faults.FAULTS[fault])
    assert not result["correct"], checks


def test_ligand_traffic_is_deterministic_and_seeds_move_only_coordinates():
    mix = traffic.load("ligand.train")
    pool, packing = traffic_ligand.training_pool(mix)
    assert len(packing) >= mix["batches"]
    assert traffic_ligand.training_pool(mix)[0] == pool
    a = traffic_ligand.arrays(pool[0], mix, 7, 0)
    b = traffic_ligand.arrays(pool[0], mix, 8, 0)
    assert a["Y"].shape == b["Y"].shape and (a["Y"] != b["Y"]).any()
    chains, n_lig, bp = pool[0]
    assert 15 <= n_lig <= 60 and 12 <= bp <= 24
    assert a["Y"].shape[0] == n_lig + 2 * bp * len(traffic_ligand.NUCLEOTIDE)
    assert all(s[2] == 0 for s in pool[1::2])
    assert all(12 <= s[2] <= 24 for s in pool[0::2])


def test_context_costs():
    cfg = {"HIDDEN_DIM": 128, "ATOM_CONTEXT_NUM": 25, "NUM_CONTEXT_LAYERS": 2,
           "NUM_RBF": 16, "MIXED_PRECISION": 1, "NUM_NEIGHBORS": 32,
           "NUM_ENCODER_LAYERS": 3, "NUM_DECODER_LAYERS": 3, "NUM_LETTERS": 21}
    H = 128
    ops = costs_ligand.context_layers_ops(1, cfg)
    # the pairs' products dominate: W_edges_y and two rounds of W1's edge half and
    # W2; the atoms' and the residue's products add about a fifth
    assert 625 * 10 * H * H < ops < 625 * 13 * H * H
    t = costs_ligand.context_layers_seconds(6000, cfg)
    assert t == pytest.approx(costs_ligand.context_layers_ops(6000, cfg)
                              / costs.PEAK_FLOPS["bf16"], rel=0.05)
    assert costs_ligand.train_flops(6000, cfg) > 3 * costs_ligand.context_layers_ops(6000, cfg)


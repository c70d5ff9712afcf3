"""Each cell's check fails its control and the faults the cell can have.

The control is the reference in the next lower precision in the program's
place (TF32 for the float32 serving cells, float8 for the bf16 training
cell); the faults are planted in the program (``faults.py``). On the CPU at
small sizes; the same runs at the cells' own sizes are the card tests
below."""
import pytest

from port_bench import faults, run
from port_bench.tests import small

CONTROLS = {"design.rna": "tf32", "specificity.dna": "tf32", "design.score": "tf32",
            "design.train": "fp8"}
CELL_FAULTS = [("design.rna", "token"), ("design.rna", "temperature"),
               ("specificity.dna", "token"), ("specificity.dna", "temperature"),
               ("specificity.dna", "argmax"),
               ("specificity.dna", "half"), ("design.score", "answer"),
               ("design.score", "half"), ("design.train", "half"),
               ("design.train", "frozen")]


@pytest.fixture
def unpatched():
    """The program's attributes that faults patch, restored afterwards."""
    from na_mpnn_tpu_torch.models import mpnn
    from na_mpnn_tpu_torch.train import optimizer, trainer
    saved = [(mpnn, "sample", mpnn.sample), (mpnn, "score", mpnn.score),
             (trainer.Trainer, "loss_and_grads", trainer.Trainer.loss_and_grads),
             (optimizer.NoamAdam, "update", optimizer.NoamAdam.update)]
    yield
    for owner, name, value in saved:
        setattr(owner, name, value)


def _fails(checks):
    return any(not v <= lim for _, v, lim in checks)


@pytest.mark.parametrize("workload", sorted(CONTROLS))
def test_control_fails(workload):
    _, checks, extra = run.run_cell(workload, 21, 0.2, False, device="cpu",
                                    overrides=small.mix(workload),
                                    controls=(CONTROLS[workload],))
    assert not _fails(checks)
    limits = {k: lim for k, _, lim in checks}
    control = extra[CONTROLS[workload]]
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_fault_fails(workload, fault, unpatched):
    result, checks, _ = run.run_cell(workload, 22, 0.2, False, device="cpu",
                                     overrides=small.mix(workload),
                                     plant=faults.FAULTS[fault])
    assert not result["correct"], checks


def _cell(workload, seed, fault, controls):
    """One run of a cell at its own size on the card, in this process."""
    result, checks, extra = run.run_cell(workload, seed, 3.0, False, device="cuda",
                                         plant=faults.FAULTS[fault] if fault else None,
                                         controls=controls)
    return result["correct"], checks, extra


def on_card(workload, seed, fault=None, controls=()):
    """``_cell`` in a process of its own, as the benchmark runs each cell:
    the card's memory and the planted faults end with it."""
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_cell, (workload, seed, fault, controls))


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(CONTROLS))
def test_control_and_program_on_the_card(workload, card):
    """At the cell's own size on the card: the program passes and the
    control fails, on three seeds."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        correct, checks, extra = on_card(workload, seed, controls=(CONTROLS[workload],))
        assert correct, checks
        limits = {k: lim for k, _, lim in checks}
        assert any(extra[CONTROLS[workload]][k] > limits[k] for k in limits)


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_fault_on_the_card(workload, fault, card):
    correct, checks, _ = on_card(workload, 2 ** 31 + 104, fault)
    assert not correct, checks


def test_draw_z_reads_a_sound_draw_low_and_a_wrong_one_high():
    """Tokens drawn from q read about |N(0, 1)|; the likeliest letter, a
    draw at ten times the temperature and an omitted letter read far
    higher."""
    import torch

    from port_bench.drivers import cli
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(4, 300, 33, generator=g, dtype=torch.float64) * 0.5
    lq = torch.log_softmax(logits / 0.3, -1)
    d = torch.ones(300, dtype=torch.bool)

    def z(S):
        return cli.draw_z(cli.draw_terms(lq, S, d))
    sound = [z(torch.multinomial(lq.exp().view(-1, 33), 1, generator=g).view(4, 300))
             for _ in range(20)]
    assert max(sound) < 4.5
    assert z(lq.argmax(-1)) > 20
    hot = torch.softmax(logits / 3.0, -1).view(-1, 33)
    assert z(torch.multinomial(hot, 1, generator=g).view(4, 300)) > 20
    lq_omit = lq.clone()
    lq_omit[..., 5] = -1e9
    S = torch.multinomial(lq.exp().view(-1, 33), 1, generator=g).view(4, 300)
    S[0, 0] = 5
    assert cli.draw_z(cli.draw_terms(lq_omit, S, d)) > 1e3


def test_worst_keeps_nan():
    """A NaN answer reads as NaN, which fails every limit, not as the
    largest of the other gaps."""
    import math

    import torch

    from port_bench.drivers import worst
    assert math.isnan(worst(0.0, torch.tensor(float("nan"))))
    assert math.isnan(worst(x for x in [1.0, float("nan"), 2.0]))
    assert worst(1.0, torch.tensor(2.5), 2) == 2.5

"""The sampler's decode loop as one CUDA graph (``models/mpnn.py::
_decode_loop``). On the CPU every step runs eagerly and ``sample.decode``
counts its steps with none replayed. On a card (the tests marked ``cuda``,
which skip without one) the graph path is held to the same step function
run eagerly on the card (``_EAGER_STEPS`` raised past L): the same seed
gives the same tokens and decode orders, and the probabilities within
1e-6, at B=1 and B=30, with a bias, with a pair bias, with the noise given,
from the default generator, for ``sample_multi``, and on a structure no
longer than the eager steps; ``replayed`` is L less the eager steps there;
and the graph-parallel sampler at G=1 still gives ``sample``'s tokens.

This file imports no JAX. On a card, without the suite's conftest (which
does):

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_sample_graph.py
"""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import collections

import numpy as np
import pytest
import torch

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch import trace
from na_mpnn_tpu_torch.data.featurize import featurize_inference, make_pair_bias_ctx
from na_mpnn_tpu_torch.data.pdb import parse_pdb
from na_mpnn_tpu_torch.models import (ModelConfig, build_decode_groups, init_params,
                                      mpnn, sample, sample_multi, sample_tied)

SMALL = dict(node_features=32, edge_features=32, hidden_dim=32, k_neighbors=8)
# the README's design (4oqu: one 97-nt RNA chain) and specificity (1am9:
# 296 protein residues in four chains, 93 nt of DNA) shapes
DESIGN = (("A", "rna", 97),)
SPECIFICITY = (("A", "protein", 74), ("B", "protein", 74), ("C", "protein", 74),
               ("D", "protein", 74), ("E", "dna", 47), ("F", "dna", 46))
SHORT = (("A", "rna", 2),)


@pytest.fixture
def tracer():
    trace.clear()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.clear()


def _decodes(tracer):
    by = collections.defaultdict(list)
    for r in tracer.records():
        by[r.name].append(r)
    decode, = by["sample.decode"]
    return decode, by["sample.step"]


def _batch(tmp_path, chains, device, design=None):
    """A synthetic structure of ``chains`` featurized on ``device``; the
    chains of kind ``design`` are designed (all where None), the rest
    fixed."""
    path = str(tmp_path / "s.pdb")
    write_synthetic_pdb(path, chains, seed=len(chains))
    kinds = np.concatenate([[kind] * n for _, kind, n in chains])
    chain_mask = (np.ones(len(kinds)) if design is None
                  else (kinds == design)).astype(np.int32)
    return featurize_inference(parse_pdb(path), chain_mask, device=device)


# --------------------------------------------------------------------------
# CPU: every step eager, none replayed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("sample_graph")
    cfg = ModelConfig(**SMALL)
    return cfg, init_params(3, cfg, device="cpu"), _batch(
        d, (("A", "protein", 12), ("B", "dna", 8)), "cpu")


@pytest.mark.parametrize("entry", ["sample", "sample_multi", "sample_tied"])
def test_decode_counts_on_cpu(cpu_case, tracer, entry):
    cfg, params, batch = cpu_case
    L = batch["S"].shape[-1]
    g = torch.Generator().manual_seed(5)
    if entry == "sample":
        sample(params, cfg, batch, g, num_samples=2)
        steps = L
    elif entry == "sample_multi":
        sample_multi(params, cfg, {k: torch.cat([v, v]) for k, v in batch.items()},
                     g, samples_per_structure=2)
        steps = L
    else:
        groups, weights, flat = build_decode_groups(np.arange(L), [[0, 3]], [[]], L)
        sample_tied(params, cfg, batch, g, groups, weights, flat, num_samples=2)
        steps = groups.shape[0]
    decode, step_spans = _decodes(tracer)
    assert decode.counts == {"steps": steps, "replayed": 0}
    assert len(step_spans) == steps
    assert all(decode.t0 <= r.t0 <= r.t1 <= decode.t1 for r in step_spans)


@pytest.mark.parametrize("L", [1, mpnn._EAGER_STEPS, mpnn._EAGER_STEPS + 3])
def test_decode_loop_runs_every_step_eagerly_on_cpu(tracer, L):
    calls = []
    mpnn._decode_loop(lambda: calls.append(1), L, torch.device("cpu"), None)
    decode, step_spans = _decodes(tracer)
    assert len(calls) == len(step_spans) == L
    assert decode.counts == {"steps": L, "replayed": 0}


# --------------------------------------------------------------------------
# The card: the graph path against the same step run eagerly
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card(tmp_path_factory):
    """(config, full-width weights, {name: batch}) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("sample_graph_card")
    cfg = ModelConfig()
    batches = {name: _batch(d, chains, "cuda", design)
               for name, chains, design in (("design", DESIGN, None),
                                            ("specificity", SPECIFICITY, "dna"),
                                            ("short", SHORT, None))}
    return cfg, init_params(7, cfg, device="cuda"), batches


def _graphed_and_eager(monkeypatch, run):
    """``run()`` as the program runs it, then with every step eager."""
    got = run()
    with monkeypatch.context() as m:
        m.setattr(mpnn, "_EAGER_STEPS", 1 << 30)
        want = run()
    torch.cuda.synchronize()
    return got, want


def _assert_same(got, want):
    assert torch.equal(got["S"], want["S"])
    assert torch.equal(got["decoding_order"], want["decoding_order"])
    for k in ("log_probs", "sampling_probs"):
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)


CASES = {
    # name: (structure, rows, temperature, extras)
    "design_b1": ("design", 1, 0.1, ()),
    "specificity_b30": ("specificity", 30, 0.6, ()),
    "bias": ("specificity", 30, 0.6, ("bias",)),
    "pair_bias": ("specificity", 30, 0.6, ("pair_bias",)),
    "gumbel": ("design", 30, 0.1, ("gumbel",)),
    "default_generator": ("design", 4, 0.1, ("default_generator",)),
    "short": ("short", 3, 0.1, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_matches_eager_on_card(card, monkeypatch, name):
    cfg, params, batches = card
    which, B, T, extras = CASES[name]
    batch = batches[which]
    L, nl = batch["S"].shape[-1], cfg.num_letters
    rng = np.random.RandomState(len(name))
    kw = {}
    if "bias" in extras:
        kw["bias"] = torch.from_numpy(rng.randn(L, nl) * 0.5).float().cuda()
    if "pair_bias" in extras:
        P = np.zeros((nl, nl), np.float32)
        P[rng.randint(0, 20, 12), rng.randint(0, 20, 12)] = 1.5
        kw["pair_bias_ctx"] = make_pair_bias_ctx(
            batch["chain_labels"][0].cpu().numpy(), batch["R_idx"][0].cpu().numpy(),
            P, device="cuda")
    if "gumbel" in extras:
        u = torch.from_numpy(rng.rand(L, B, nl)).float().clamp_min(1e-30)
        kw["gumbel"] = (-torch.log(-torch.log(u))).cuda()

    def run():
        if "default_generator" in extras:
            torch.manual_seed(11)
            g = None
        else:
            g = torch.Generator(device="cuda").manual_seed(11)
        return sample(params, cfg, batch, g, num_samples=B, temperature=T, **kw)

    got, want = _graphed_and_eager(monkeypatch, run)
    _assert_same(got, want)


@pytest.mark.cuda
def test_sample_multi_graph_matches_eager_on_card(card, monkeypatch):
    cfg, params, batches = card
    batch = batches["design"]
    two = {k: torch.cat([v, v]) for k, v in batch.items()}

    def run():
        g = torch.Generator(device="cuda").manual_seed(13)
        return sample_multi(params, cfg, two, g, samples_per_structure=3)

    got, want = _graphed_and_eager(monkeypatch, run)
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["design", "short"])
def test_replayed_count_on_card(card, tracer, which):
    cfg, params, batches = card
    batch = batches[which]
    L = batch["S"].shape[-1]
    sample(params, cfg, batch, torch.Generator(device="cuda").manual_seed(1))
    decode, step_spans = _decodes(tracer)
    replayed = L - mpnn._EAGER_STEPS if L > mpnn._EAGER_STEPS else 0
    assert decode.counts == {"steps": L, "replayed": replayed}
    assert len(step_spans) == L


@pytest.mark.cuda
def test_graph_parallel_one_rank_gives_sample_tokens_on_card(card, tmp_path):
    import torch.distributed as dist

    from na_mpnn_tpu_torch.parallel.graph_parallel import sample_graph_parallel
    from na_mpnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    cfg, params, batches = card
    batch = batches["specificity"]
    initialize_distributed(1, 0, "cuda", init_file=str(tmp_path / "store"))
    try:
        gp = sample_graph_parallel(params, cfg, batch,
                                   torch.Generator(device="cuda").manual_seed(17),
                                   make_mesh(1, 1, "cuda"), num_samples=30,
                                   temperature=0.6)
    finally:
        dist.destroy_process_group()
    ref = sample(params, cfg, batch, torch.Generator(device="cuda").manual_seed(17),
                 num_samples=30, temperature=0.6)
    assert torch.equal(gp["S"], ref["S"])
    assert torch.equal(gp["decoding_order"], ref["decoding_order"])

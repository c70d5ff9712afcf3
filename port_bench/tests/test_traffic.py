"""The traffic generator: deterministic by seed, the lengths its parameters
state, and the same work for every seed."""
import collections

import numpy as np
import pytest

from port_bench import traffic
from port_bench.reference import structure
from port_bench.tests import small

MIXES = ["design.rna", "specificity.dna", "design.score"]
# a mix that draws its lengths, as a later mix may
DRAWN = {"rounds": 8, "round": [
    {"count": 7, "polymers": [
        {"kind": "rna", "chains": [1, 2], "length": {"dist": "loguniform", "lo": 40, "hi": 400}}]},
    {"count": 3, "polymers": [
        {"kind": "protein", "chains": [1, 1], "length": {"dist": "uniform", "lo": 100, "hi": 300}},
        {"kind": "rna", "chains": [1, 2], "length": {"dist": "loguniform", "lo": 40, "hi": 400}}]}]}


def _sizes(pool):
    return collections.Counter(tuple((k, n) for _, k, n in s) for s in pool)


@pytest.mark.parametrize("name", MIXES + ["drawn"])
def test_pool_is_deterministic_and_seeds_change_only_the_order(name):
    mix = DRAWN if name == "drawn" else traffic.load(name)
    a, b = traffic.structure_pool(mix, 7), traffic.structure_pool(mix, 7)
    c = traffic.structure_pool(mix, 2 ** 31 + 11)
    assert a == b
    assert a != c or len({tuple(s) for s in a}) == 1
    assert _sizes(a) == _sizes(c)
    assert len(a) == mix["rounds"] * sum(g["count"] for g in mix["round"])


@pytest.mark.parametrize("name", MIXES)
def test_published_chains_are_kept_whole(name):
    mix = traffic.load(name)
    want = collections.Counter()
    for group in mix["round"]:
        chains = tuple((p["kind"], n) for p in group["polymers"] for n in p["lengths"])
        want[chains] += group["count"] * mix["rounds"]
    assert _sizes(traffic.structure_pool(mix, 2 ** 33 + 1)) == want


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_its_source(name):
    mix = traffic.load(name)
    assert mix["source"] and isinstance(mix["assumed"], list)


@pytest.mark.parametrize("mix", [small.SERVE, DRAWN])
def test_lengths_follow_the_parameters(mix):
    pool = traffic.structure_pool(mix, 3)
    for group in mix["round"]:
        for poly in group["polymers"]:
            lo, hi = poly["length"]["lo"], poly["length"]["hi"]
            kinds = [[n for _, k, n in s if k == poly["kind"]] for s in pool]
            per = [sum(ns) if not poly.get("each") else ns[0] for ns in kinds if ns]
            assert min(per) >= lo and max(per) <= hi
            chains = {len(ns) for ns in kinds if ns}
            assert chains <= set(range(poly["chains"][0], poly["chains"][1] + 1))


def test_rounds_weigh_alike():
    mix = DRAWN
    pool = traffic.structure_pool(mix, 5)
    per = sum(g["count"] for g in mix["round"])
    totals = [sum(n for s in pool[r * per:(r + 1) * per] for _, _, n in s)
              for r in range(mix["rounds"])]
    assert max(totals) / min(totals) < 1.35


def test_quantiles():
    d = {"dist": "loguniform", "lo": 40, "hi": 400}
    assert traffic.quantile_length(d, 0.0) == 40
    assert traffic.quantile_length(d, 1.0) == 400
    assert traffic.quantile_length(d, 0.5) == round(40 * 10 ** 0.5)
    n = {"dist": "lognormal", "median": 400, "sigma": 0.7, "lo": 64, "hi": 6000}
    assert traffic.quantile_length(n, 0.5) == 400


def test_pdb_round_trip(tmp_path):
    chains = [("A", "protein", 12), ("B", "rna", 7), ("C", "dna", 5)]
    path = str(tmp_path / "s.pdb")
    assert traffic.write_pdb(path, chains, 9, 0) == 24
    s = structure.read_pdb(path)
    assert s["protein_mask"].sum() == 12 and s["rna_mask"].sum() == 7
    assert s["dna_mask"].sum() == 5 and list(s["chain_labels"][[0, 12, 19]]) == [0, 1, 2]
    again = str(tmp_path / "t.pdb")
    traffic.write_pdb(again, chains, 9, 0)
    assert open(path).read() == open(again).read()
    traffic.write_pdb(again, chains, 2 ** 31 + 9, 0)
    assert open(path).read() != open(again).read()


def test_training_pool():
    mix = traffic.load("design.train")
    structures, batches = traffic.training_pool(mix)
    assert len(batches) >= mix["batches"]
    lengths = [sum(n for _, _, n in s) for s in structures]
    assert min(lengths) >= mix["length"]["lo"] and max(lengths) <= mix["length"]["hi"]
    for b in batches:
        assert len(b) * max(lengths[i] for i in b) <= mix["batch_tokens"]
    a = traffic.arrays(structures[0], 4, 0)
    b = traffic.arrays(structures[0], 4, 0)
    c = traffic.arrays(structures[0], 5, 0)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["X"], c["X"])
    assert (a["protein_mask"] + a["dna_mask"] + a["rna_mask"] == 1).all()

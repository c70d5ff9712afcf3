"""Batched multi-structure design in the port (``eval/batch_design.py``) on
the CPU, at the full width of the released model, against the JAX
package's ``eval/batch_design.py`` on the same three synthetic PDBs and the
same checkpoint: ``bucket=16`` and ``batch_structures=2``, so one group is
full and one is padded with a dummy row. The two draw from different
generators, so the files, FASTA header fields, native lines and npz keys
and shapes are compared, not the designs; the packed rows are held to
``sample_multi`` on each structure alone at float64 (same decode order and
noise, tokens exact, probabilities within 1e-10)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from na_mpnn_tpu import constants as jc
from na_mpnn_tpu.data.featurize import featurize_inference as jax_featurize
from na_mpnn_tpu.data.featurize import make_pair_bias_ctx as jax_pair_ctx
from na_mpnn_tpu.eval import batch_design as jbd
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train.checkpoint import save_checkpoint_npz

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch.data.featurize import featurize_inference, make_pair_bias_ctx
from na_mpnn_tpu_torch.data.pdb import parse_pdb
from na_mpnn_tpu_torch.eval import batch_design as bd
from na_mpnn_tpu_torch.models import ModelConfig, init_params, sample_multi

# lengths 20, 26 (bucket 32: one full group) and 38 (bucket 48, one dummy row)
CHAINS = ((("A", "protein", 12), ("B", "dna", 8)),
          (("A", "protein", 14), ("B", "dna", 6), ("C", "dna", 6)),
          (("A", "protein", 22), ("B", "dna", 8), ("C", "rna", 8)))
KW = dict(bucket=16, batch_structures=2, seed=11)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bd")
    paths = []
    for i, chains in enumerate(CHAINS):
        paths.append(str(d / f"s{i}.pdb"))
        write_synthetic_pdb(paths[-1], chains, seed=20 + i)
    ckpt = str(d / "model.npz")
    save_checkpoint_npz(ckpt, jax_init(jax.random.PRNGKey(4), JaxConfig()), meta={})
    return d, paths, ckpt


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _header_fields(line):
    return [item.split("=")[0].strip() for item in line[1:].split(",")]


def test_design_and_specificity_match_jax(inputs):
    d, paths, ckpt = inputs
    out_j, out_t = str(d / "jax"), str(d / "torch")
    res_j = jbd.design_structures(paths, ckpt, out_j, samples_per_structure=2,
                                  write_design_json=True, **KW)
    res_t = bd.design_structures(paths, ckpt, out_t, samples_per_structure=2,
                                 write_design_json=True, device="cpu", **KW)
    jbd.predict_specificities(paths, ckpt, out_j, samples_per_structure=2, **KW)
    res_s = bd.predict_specificities(paths, ckpt, out_t, samples_per_structure=2,
                                     device="cpu", **KW)
    assert sorted(res_t) == sorted(res_j) == ["s0", "s1", "s2"]
    assert _files(out_t) == _files(out_j)
    for rel in _files(out_j):
        a, b = os.path.join(out_j, rel), os.path.join(out_t, rel)
        if rel.endswith(".fa"):
            fa, fb = open(a).read().splitlines(), open(b).read().splitlines()
            assert len(fa) == len(fb) == 6
            for la, lb in zip(fa[0::2], fb[0::2]):
                assert _header_fields(la) == _header_fields(lb)
            assert fa[0] == fb[0] and fa[1] == fb[1]     # the native record
            assert [len(x) for x in fa[1::2]] == [len(x) for x in fb[1::2]]
        elif rel.endswith(".npz"):
            za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].shape == zb[k].shape, (rel, k)
            np.testing.assert_array_equal(za["true_sequence"], zb["true_sequence"])
    for name, r in res_s.items():
        ppm = r["predicted_ppm"]
        assert ppm.shape == (len(parse_pdb(paths[int(name[1])])["S"]), jc.NUM_LETTERS)
        z = np.load(r["ppm_path"])
        na = (z["dna_mask"] + z["rna_mask"]).astype(bool)
        assert np.allclose(ppm[~na], 0.0)      # protein rows are not designed
        np.testing.assert_allclose(ppm[na].sum(-1), 1.0, atol=1e-5)
    for r in res_t.values():
        assert all(0.0 <= x <= 1.0 for x in r["seq_rec"])


def test_packed_rows_equal_sample_multi_alone(inputs):
    """The packed group (two structures padded to 32, or one and a dummy row
    at 48) decodes each structure as ``sample_multi`` does on that
    structure alone, under the same decode order and Gumbel noise rows."""
    _, paths, _ = inputs
    cfg = ModelConfig(hidden_dim=32, node_features=32, edge_features=32,
                      k_neighbors=8, dropout=0.0)
    params = init_params(1, cfg, device="cpu", dtype=torch.float64)
    S_rep, nl = 2, jc.NUM_LETTERS
    rng = np.random.RandomState(5)
    parsed = [parse_pdb(p) for p in paths]
    for members, Lp in (([0, 1], 32), ([2], 48)):
        packed = bd.pack_group([parsed[i] for i in members], Lp, 2, True)
        assert packed["S"].shape == (2, Lp)
        if len(members) == 1:
            assert not packed["mask"][1].any()            # the dummy row
        rows = 2 * S_rep
        order = np.stack([rng.permutation(Lp) for _ in range(rows)])
        gumbel = rng.gumbel(size=(Lp, rows, nl))
        bias = rng.randn(Lp, nl) * 0.2

        def run(batch, sl):
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            b["X"] = b["X"].double()
            b["decoding_order"] = torch.from_numpy(order[sl])
            return sample_multi(params, cfg, b, None, samples_per_structure=S_rep,
                                temperature=0.4, bias=torch.from_numpy(bias),
                                gumbel=torch.from_numpy(gumbel[:, sl]))

        together = run(packed, slice(None))
        for i in range(len(members)):
            sl = slice(i * S_rep, (i + 1) * S_rep)
            alone = run({k: v[i:i + 1] for k, v in packed.items()}, sl)
            assert torch.equal(alone["S"], together["S"][sl])
            for k in ("sampling_probs", "log_probs"):
                torch.testing.assert_close(alone[k], together[k][sl], atol=1e-10,
                                           rtol=0)


def test_featurize_as_numpy_matches_jax(inputs):
    _, paths, _ = inputs
    parsed = parse_pdb(paths[1])
    cm = np.ones(len(parsed["S"]), np.int32)
    a = featurize_inference(parsed, cm, pad_to=32, as_numpy=True)
    b = jax_featurize(parsed, cm, pad_to=32, as_numpy=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert isinstance(a[k], np.ndarray)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    P = bd.parse_pair_bias_AA("at:0.5,cg:-0.3")
    np.testing.assert_array_equal(P, jbd.parse_pair_bias_AA("at:0.5,cg:-0.3"))
    ca = make_pair_bias_ctx(a["chain_labels"][0], a["R_idx"][0], P, as_numpy=True)
    cb = jax_pair_ctx(b["chain_labels"][0], b["R_idx"][0], P, as_numpy=True)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k])


def test_failure_catcher_seed_zero_and_pair_bias(inputs, tmp_path):
    _, paths, ckpt = inputs
    bad = tmp_path / "garbage.pdb"
    bad.write_text("not a pdb\n")
    out = str(tmp_path / "fc")
    res = bd.design_structures([str(bad), paths[0]], ckpt, out,
                               samples_per_structure=1, catch_failures=True,
                               device="cpu", bucket=16, batch_structures=2, seed=0,
                               pair_bias_AA=bd.parse_pair_bias_AA("at:0.5,cg:-0.3"))
    assert "s0" in res and "garbage" not in res
    failed = os.path.join(out, "failed_inferences", "garbage.txt")
    assert "garbage.pdb" in open(failed).read()
    # seed 0 draws a seed and the headers record it
    header = open(res["s0"]["fasta_path"]).read().splitlines()[2]
    assert int(header.split("seed=")[1].split(",")[0]) != 0
    with pytest.raises(Exception):
        bd.design_structures([str(bad)], ckpt, str(tmp_path / "fc2"),
                             samples_per_structure=1, device="cpu", **KW)


def test_failure_retires_the_parse_worker(inputs, tmp_path):
    _, paths, ckpt = inputs
    bad = tmp_path / "garbage.pdb"
    bad.write_text("not a pdb\n")
    with pytest.raises(Exception):
        bd.design_structures([str(bad)] + [paths[0]] * 30, ckpt,
                             str(tmp_path / "out"), samples_per_structure=1,
                             device="cpu", **KW)

    def alive():
        return any(t.name == "na-mpnn-parse-ahead" and t.is_alive()
                   for t in threading.enumerate())

    deadline = time.time() + 15
    while alive() and time.time() < deadline:
        time.sleep(0.1)
    assert not alive()


def test_main_reads_a_csv(inputs, tmp_path):
    _, paths, ckpt = inputs
    csv_path = tmp_path / "structs.csv"
    csv_path.write_text("structure_path,note\n" + f"{paths[0]},a\n{paths[1]},b\n")
    out = str(tmp_path / "cli")
    bd.main(["--csv", str(csv_path), "--checkpoint", ckpt, "--out_folder", out,
             "--samples", "1", "--seed", "3", "--batch_structures", "2",
             "--bucket", "16", "--device", "cpu"])
    assert os.path.exists(os.path.join(out, "seqs", "s0.fa"))
    assert os.path.exists(os.path.join(out, "seqs", "s1.fa"))
    bad_csv = tmp_path / "bad.csv"
    bad_csv.write_text("path\nx.pdb\n")
    with pytest.raises(ValueError, match="structure_path"):
        bd.read_structure_paths(str(bad_csv))

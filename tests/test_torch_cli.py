"""The port's CLI on the CPU (``--device cpu``) against the JAX package's CLI
on the same PDB (protein, DNA and RNA with the full backbone, O2' on RNA)
and the same ``.npz`` checkpoint written by the JAX package, at the full
width of the released model: the same output files, fields and shapes, and
in score mode the same unconditional log-probs (1e-4; the two sample with
different generators, so only deterministic outputs are compared). The
``symmetry`` mode ties positions with ``--symmetry_residues``: both CLIs
draw equal tokens at tied positions in every sample."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import os

import numpy as np
import pytest

import jax

from na_mpnn_tpu.cli.run import cli_entry as jax_cli
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train.checkpoint import save_checkpoint_npz

from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch.cli.run import cli_entry

MODES = {
    "design": ["--mode", "design", "--bias_AA", "A:0.5,G:-0.3", "--omit_AA", "XC",
               "--pair_bias_AA", "ac:1.0,GA:0.5", "--fixed_residues", "A1 A2 B3",
               "--chains_to_design", "A,B,D", "--batch_size", "2",
               "--number_of_batches", "2", "--pad_to_bucket", "16"],
    "specificity": ["--mode", "specificity", "--design_na_only", "1",
                    "--output_specificity", "1", "--batch_size", "3",
                    "--output_pdbs", "0"],
    "score": ["--mode", "score", "--batch_size", "2",
              "--redesigned_residues", "A3 A4", "--number_of_batches", "2"],
    "na_only": ["--mode", "design", "--parse_na_only", "1", "--batch_size", "2"],
    "symmetry": ["--mode", "design", "--symmetry_residues", "B1,C1|B2,C2,C3",
                 "--symmetry_weights", "1.0,0.5|1.0,1.0,2.0", "--batch_size", "3",
                 "--pair_bias_AA", "ac:1.0", "--number_of_batches", "2"],
}
# positions tied by the symmetry mode (A holds residues 0-17, B 18-25, C 26-33)
TIED = ([18, 26], [19, 27, 28])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    pdb = str(d / "mix.pdb")
    write_synthetic_pdb(pdb, (("A", "protein", 18), ("B", "dna", 8),
                              ("C", "dna", 8), ("D", "rna", 6)), seed=4)
    ckpt = str(d / "model.npz")
    save_checkpoint_npz(ckpt, jax_init(jax.random.PRNGKey(5), JaxConfig()),
                        meta={})
    return d, pdb, ckpt


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def compare_with_jax_cli(inputs, mode):
    """Run both CLIs in ``mode`` and compare their outputs."""
    d, pdb, ckpt = inputs
    common = ["--checkpoint_na_mpnn", ckpt, "--pdb_path", pdb, "--seed", "3",
              "--save_stats", "1", "--stats_format", "npz", *MODES[mode]]
    out_j, out_t = str(d / f"jax_{mode}"), str(d / f"torch_{mode}")
    jax_cli(["--out_folder", out_j, *common])
    cli_entry(["--out_folder", out_t, "--device", "cpu", *common])
    assert _files(out_j) == _files(out_t)
    for rel in _files(out_j):
        if rel.endswith(".npz"):
            a = np.load(os.path.join(out_j, rel), allow_pickle=True)
            b = np.load(os.path.join(out_t, rel), allow_pickle=True)
            assert sorted(a.files) == sorted(b.files), rel
            for k in a.files:
                assert a[k].shape == b[k].shape, (rel, k)
            if "native_sequence" in a.files:
                np.testing.assert_array_equal(a["native_sequence"],
                                              b["native_sequence"])
                np.testing.assert_array_equal(a["chain_mask"], b["chain_mask"])
        elif rel.endswith(".fa"):
            fa = open(os.path.join(out_j, rel)).read().splitlines()
            fb = open(os.path.join(out_t, rel)).read().splitlines()
            assert len(fa) == len(fb)
            assert fa[1] == fb[1]            # native sequence by chains
            assert [len(x) for x in fa[1::2]] == [len(x) for x in fb[1::2]]
    if mode == "score":
        a = np.load(os.path.join(out_j, "stats", "mix.npz"))
        b = np.load(os.path.join(out_t, "stats", "mix.npz"))
        np.testing.assert_allclose(b["unconditional_log_probs"],
                                   a["unconditional_log_probs"], atol=1e-4)
    if mode == "design":
        b = np.load(os.path.join(out_t, "stats", "mix.npz"))
        S = b["generated_sequences"]
        fixed = [0, 1, 20]  # A1, A2 and B3 keep their native tokens
        np.testing.assert_array_equal(S[:, fixed],
                                      np.broadcast_to(b["native_sequence"][fixed],
                                                      (4, 3)))
        assert not (S[:, :18] == 4).any()   # 'C' (CYS) omitted
    if mode == "symmetry":
        for out in (out_j, out_t):
            S = np.load(os.path.join(out, "stats", "mix.npz"))["generated_sequences"]
            assert S.shape == (6, 40)
            for tied in TIED:
                assert (S[:, tied] == S[:, tied[:1]]).all(), (out, S[:, tied])


@pytest.mark.parametrize("mode", ["design", "na_only", "symmetry"])
def test_cli_outputs_match_jax_cli(inputs, mode):
    compare_with_jax_cli(inputs, mode)

"""The port's own copies of the JAX package's tables, checkpoint layouts,
PDB parser and featuriser give what the JAX package gives."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import numpy as np
import pytest
import torch

import jax

import na_mpnn_tpu.constants as jc
from na_mpnn_tpu.data.featurize import featurize_inference as jax_featurize
from na_mpnn_tpu.data.pdb import parse_pdb as jax_parse
from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.train import checkpoint as jckpt

import na_mpnn_tpu_torch.constants as tc
from chip_smoke import write_synthetic_pdb
from na_mpnn_tpu_torch import params as tparams
from na_mpnn_tpu_torch.data.featurize import featurize_inference
from na_mpnn_tpu_torch.data.pdb import parse_pdb
from na_mpnn_tpu_torch.models import ModelConfig

SMALL = dict(node_features=32, edge_features=32, hidden_dim=32,
             num_encoder_layers=2, num_decoder_layers=2, k_neighbors=16)


def test_constants_equal_the_jax_tables():
    names = [n for n in dir(jc) if n.isupper()]
    assert names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        a, b = getattr(jc, n), getattr(tc, n)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, n
    for shared in (True, False):
        assert jc.restype_to_int_table(shared) == tc.restype_to_int_table(shared)
        assert jc.canonical_base_pair_ints(shared) == tc.canonical_base_pair_ints(shared)
        assert jc.restype_group_ints(shared) == tc.restype_group_ints(shared)
        np.testing.assert_array_equal(jc.tokens_with_no_loss(shared),
                                      tc.tokens_with_no_loss(shared))
    np.testing.assert_array_equal(jc.polymer_restype_mask_array([1, 5]),
                                  tc.polymer_restype_mask_array([1, 5]))


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(**SMALL)
    return cfg, jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), cfg))


def _assert_same_tree(flat_a, flat_b):
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), np.asarray(flat_b[k]))


def test_from_jax_params_matches_key_for_key(jax_params):
    _, pj = jax_params
    pt = tparams.from_jax_params(pj, device="cpu")
    flat_t = tparams.flatten_pytree(pt)
    assert all(isinstance(v, np.ndarray) for v in flat_t.values())
    _assert_same_tree(jckpt.flatten_pytree(pj), flat_t)
    # linear weights keep the JAX [in, out] layout
    assert tuple(pt["encoder"][0]["W1"]["w"].shape) == (3 * 32, 32)


def test_npz_checkpoints_round_trip_both_ways(jax_params, tmp_path):
    cfg_j, pj = jax_params
    jckpt.save_checkpoint_npz(str(tmp_path / "j.npz"), pj, meta={"step": 5})
    pt, meta = tparams.load_params_any(str(tmp_path / "j.npz"),
                                       ModelConfig(**SMALL), device="cpu")
    assert meta == {"step": 5}
    _assert_same_tree(jckpt.flatten_pytree(pj), tparams.flatten_pytree(pt))
    tparams.save_checkpoint_npz(str(tmp_path / "t.npz"), pt, meta={"step": 6})
    back, meta_back, _ = jckpt.load_checkpoint_npz(str(tmp_path / "t.npz"))
    assert meta_back == {"step": 6}
    _assert_same_tree(jckpt.flatten_pytree(pj), jckpt.flatten_pytree(back))


def test_reference_pt_checkpoint_loads(jax_params, tmp_path):
    cfg_j, pj = jax_params
    path = str(tmp_path / "ref.pt")
    jckpt.save_torch_checkpoint(path, pj, cfg_j, meta={"step": 9})
    pt, meta = tparams.load_params_any(path, ModelConfig(**SMALL), device="cpu")
    assert meta == {"step": 9}
    _assert_same_tree(jckpt.flatten_pytree(pj), tparams.flatten_pytree(pt))


@pytest.fixture(scope="module")
def pdb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pdb") / "mix.pdb")
    write_synthetic_pdb(path, (("A", "protein", 20), ("B", "dna", 9),
                               ("C", "dna", 8), ("D", "rna", 7)), seed=2)
    return path


def test_parse_pdb_matches_jax(pdb_path):
    a, b = jax_parse(pdb_path), parse_pdb(pdb_path)
    assert sorted(a) == sorted(b)
    assert int(a["rna_mask"].sum()) == 7 and int(a["dna_mask"].sum()) == 17
    assert int(a["rna_mask_for_token_conversion"].sum()) == 7
    for k in a:
        if k in ("backbone_atoms", "other_atoms", "water_atoms"):
            fa = [(x.name, x.resname, x.chain, x.resnum, tuple(x.xyz))
                  for x in (sum(a[k], []) if k == "backbone_atoms" else a[k])]
            fb = [(x.name, x.resname, x.chain, x.resnum, tuple(x.xyz))
                  for x in (sum(b[k], []) if k == "backbone_atoms" else b[k])]
            assert fa == fb, k
        elif k == "mask_c":
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("pad_to", [0, 64])
def test_featurize_inference_matches_jax(pdb_path, pad_to):
    parsed_j, parsed_t = jax_parse(pdb_path), parse_pdb(pdb_path)
    chain_mask = (np.arange(44) % 3 > 0).astype(np.int32)
    bj = jax_featurize(parsed_j, chain_mask, pad_to=pad_to)
    bt = featurize_inference(parsed_t, chain_mask, pad_to=pad_to, device="cpu")
    assert sorted(bj) == sorted(bt)
    for k in bj:
        assert isinstance(bt[k], torch.Tensor)
        np.testing.assert_array_equal(np.asarray(bj[k]), bt[k].numpy(), err_msg=k)
    assert bt["S"].shape == (1, max(44, pad_to))


def test_missing_cuda_device_is_an_error(pdb_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        featurize_inference(parse_pdb(pdb_path), np.ones(44, np.int32))

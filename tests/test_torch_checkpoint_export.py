"""The port's reference ``.pt`` export (``params.to_torch_state_dict``,
``params.save_torch_checkpoint``) against the JAX package's
(``models/torch_import.py::to_torch_state_dict``,
``train/checkpoint.py::save_torch_checkpoint``) on the same parameters: the
same keys in the same order, bitwise the same arrays; the two ``.pt`` files
read back through ``torch.load`` with the same keys, meta and float32
tensors; each package loads the other's file back to the original tree,
bitwise. An orbax directory is refused, saying why."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import init_params as jax_init
from na_mpnn_tpu.models.torch_import import to_torch_state_dict as jax_to_sd
from na_mpnn_tpu.train import checkpoint as jckpt

from na_mpnn_tpu_torch import params as tparams
from na_mpnn_tpu_torch.models import ModelConfig

# the released width, and a narrower one with other layer counts
CONFIGS = {"released": {},
           "narrow": dict(hidden_dim=32, node_features=32, edge_features=32,
                          num_encoder_layers=2, num_decoder_layers=1,
                          k_neighbors=8)}
META = {"epoch": 3, "step": 1234, "save_step": 1200}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def trees(request):
    """(JAX config, port config, JAX tree, the port's tensor tree of it)."""
    cj, ct = JaxConfig(**CONFIGS[request.param]), ModelConfig(**CONFIGS[request.param])
    pj = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3), cj))
    return cj, ct, pj, tparams.from_jax_params(pj, device="cpu")


def _same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_state_dict_matches_jax(trees):
    cj, ct, pj, pt = trees
    want = jax_to_sd(pj, cj)
    got = tparams.to_torch_state_dict(pt, ct)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # linear weights [out, in]; the token embedding as stored
    assert got["W_v.weight"].shape == tuple(pt["W_v"]["w"].shape[::-1])
    np.testing.assert_array_equal(got["W_s.weight"], pt["W_s"]["emb"].numpy())
    # the inverse brings back the JAX tree
    _same_flat(jckpt.flatten_pytree(pj),
               tparams.flatten_pytree(tparams.from_torch_state_dict(got, ct)))


def test_pt_files_match_jax(trees, tmp_path):
    cj, ct, pj, pt = trees
    jckpt.save_torch_checkpoint(str(tmp_path / "j.pt"), pj, cj, meta=META)
    tparams.save_torch_checkpoint(str(tmp_path / "t.pt"), pt, ct, meta=META)
    a = torch.load(str(tmp_path / "j.pt"), map_location="cpu", weights_only=False)
    b = torch.load(str(tmp_path / "t.pt"), map_location="cpu", weights_only=False)
    assert list(a) == list(b) == [*META, "model_state_dict"]
    assert {k: b[k] for k in META} == {k: a[k] for k in META} == META
    sa, sb = a["model_state_dict"], b["model_state_dict"]
    assert list(sa) == list(sb)
    for k in sa:
        assert sb[k].dtype == torch.float32 and sb[k].is_contiguous(), k
        assert sb[k].device.type == "cpu"
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_pt(trees, tmp_path, writer):
    cj, ct, pj, pt = trees
    path = str(tmp_path / "x.pt")
    if writer == "jax":
        jckpt.save_torch_checkpoint(path, pj, cj, meta=META)
        back, meta = tparams.load_params_any(path, ct, device="cpu")
        flat = tparams.flatten_pytree(back)
    else:
        tparams.save_torch_checkpoint(path, pt, ct, meta=META)
        back, meta = jckpt.load_params_any(path, cj)
        flat = jckpt.flatten_pytree(back)
    assert meta == META
    _same_flat(jckpt.flatten_pytree(pj), flat)


def test_loaded_leaves_are_contiguous(trees, tmp_path):
    """A ``.pt`` stores linear weights ``[out, in]``; loaded back they are the
    ``[in, out]`` layout in contiguous tensors, as the CUDA kernels take them
    (a transposed view would reach them with the wrong strides)."""
    _, ct, _, pt = trees
    tparams.save_torch_checkpoint(str(tmp_path / "z.pt"), pt, ct)
    tparams.save_checkpoint_npz(str(tmp_path / "z.npz"), pt)
    for name in ("z.pt", "z.npz"):
        back, _ = tparams.load_params_any(str(tmp_path / name), ct, device="cpu")
        leaves = tparams.flatten_pytree(back)
        assert all(v.flags["C_CONTIGUOUS"] for v in leaves.values())
        flat = []
        stack = [back]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, list):
                stack.extend(node)
            else:
                flat.append(node)
        assert flat and all(t.is_contiguous() for t in flat), name


def test_export_takes_any_tree(trees, tmp_path):
    """A float64 tree and a tree of numpy leaves export as the float32 tree
    does (a float64 tree is written as float32 tensors)."""
    _, ct, pj, pt = trees
    want = tparams.to_torch_state_dict(pt, ct)
    for tree in (pj, tparams.from_jax_params(pj, device="cpu", dtype=torch.float64)):
        tparams.save_torch_checkpoint(str(tmp_path / "y.pt"), tree, ct)
        sd = torch.load(str(tmp_path / "y.pt"), weights_only=False)["model_state_dict"]
        assert list(sd) == list(want)
        for k in want:
            np.testing.assert_array_equal(sd[k].numpy(), want[k], err_msg=k)


def test_orbax_directory_is_refused(tmp_path):
    from na_mpnn_tpu_torch.train.trainer import Trainer

    d = tmp_path / "s_1000.orbax"
    d.mkdir()
    cfg = ModelConfig(**CONFIGS["narrow"])
    with pytest.raises(NotImplementedError, match="orbax.*imports jax"):
        tparams.load_params_any(str(d), cfg, device="cpu")
    trainer = Trainer(dataclasses.replace(cfg, dropout=0.0), device="cpu")
    with pytest.raises(NotImplementedError, match="orbax.*imports jax"):
        trainer.restore(str(d))

"""The JAX package's public names in the port: each one added in the last
slice against its JAX counterpart on the same inputs (the Noam schedule and
``make_optimizer``, ``features.knn_graph``, ``positional_embed``,
``init_features``, ``gather_edges``, ``gather_nodes_t``, the reference
checkpoint readers, ``read_cif_atoms``), the port's console scripts, every
module of the JAX package with a counterpart, and every name a JAX module
defines present in the port's counterpart but for the TPU names logged
under ROADMAP "Differences by design"."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import ast
import os
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import na_mpnn_tpu.data as jax_data
import na_mpnn_tpu.models.features as jf
import na_mpnn_tpu.models.modules as jm
import na_mpnn_tpu.train.optimizer as jopt
import na_mpnn_tpu_torch.data as t_data
import na_mpnn_tpu_torch.models.features as tf
import na_mpnn_tpu_torch.models.modules as tm
import na_mpnn_tpu_torch.train.optimizer as topt
from na_mpnn_tpu.models.config import ModelConfig as JaxConfig
from na_mpnn_tpu_torch.models.config import ModelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Names the JAX package defines that the port does not keep, and why
# (ROADMAP, Queue 3, "Differences by design").
TPU_NAMES = {
    # Pallas entry points, interpret-mode switches and VMEM tile constants:
    # the port's kernels are the CUDA sources of csrc/ behind ops/*.py.
    "ops/__init__.py": {"INTERPRET", "interpret_mode"},
    "ops/fused_layers.py": {"NODE_TILE", "dec_layer_fused", "enc_layer_fused"},
    "ops/message_kernels.py": {"message_agg_table_batched", "message_dec_table_batched",
                               "message_edge_table_batched", "message_mlp_table"},
    "ops/knn.py": {"QUERY_TILE", "knn_graph_pallas", "knn_graph_pallas_qk"},
    "ops/rbf_classed.py": {"EDGE_TILE", "GROUP_SELS", "GROUP_SLICES", "MASK_FAR", "NP_",
                           "NUM_GROUPS", "N_SEL", "PERM", "P_SEL", "group_rows",
                           "split_weight_tables"},
    "ops/rbf_edge.py": {"A", "EDGE_TILE", "permute_rbf_weight", "rbf_edge_embed",
                        "rbf_edge_embed_dw", "rbf_weight_permutation"},
    # a shard_map mesh-axis name; the port's graph axis is a process group
    "parallel/graph_parallel.py": {"GRAPH_AXIS"},
}
# JAX modules whose content lives in another file of the port
MOVED = {"models/torch_import.py": "params.py", "train/checkpoint.py": "params.py"}


def _jax_files():
    base = os.path.join(ROOT, "na_mpnn_tpu")
    for dp, dn, fn in os.walk(base):
        dn[:] = [d for d in dn if d != "__pycache__"]
        for f in fn:
            if not f.endswith((".pyc", ".so")) and ".tmp" not in f:
                yield os.path.relpath(os.path.join(dp, f), base)


def test_every_jax_file_has_a_counterpart():
    files = sorted(_jax_files())
    assert "native/na_parse.cc" in files and "utils/geometry.py" in files
    for rel in files:
        ours = os.path.join(ROOT, "na_mpnn_tpu_torch", MOVED.get(rel, rel))
        assert os.path.exists(ours), rel


def _defined(path):
    """(public names a module defines: functions, classes, assignments and
    ``__all__``; names it imports from other modules)."""
    tree = ast.parse(open(path).read())
    defined, imported = set(), set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            defined.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    defined |= set(ast.literal_eval(n.value))
                elif isinstance(t, ast.Name):
                    defined.add(t.id)
        elif isinstance(n, ast.ImportFrom):
            imported |= {a.asname or a.name for a in n.names}
    return {d for d in defined if not d.startswith("_")}, imported


def test_public_names_kept_or_logged():
    for rel in sorted(_jax_files()):
        if not rel.endswith(".py") or rel in MOVED:
            continue
        jax_names, _ = _defined(os.path.join(ROOT, "na_mpnn_tpu", rel))
        ours, imported = _defined(os.path.join(ROOT, "na_mpnn_tpu_torch", rel))
        missing = jax_names - ours - imported - TPU_NAMES.get(rel, set())
        assert not missing, (rel, sorted(missing))
        kept_anyway = TPU_NAMES.get(rel, set()) & (ours | imported)
        assert not kept_anyway, (rel, sorted(kept_anyway))


def test_noam_schedule_matches_jax():
    for d_model, factor, warmup in ((128, 2.0, 4000), (64, 1.5, 100)):
        ours = topt.noam_schedule(d_model, factor, warmup)
        theirs = jopt.noam_schedule(d_model, factor, warmup)
        opt = topt.make_optimizer(d_model, factor, warmup)
        for step in (0, 1, 2, 3, 99, 100, 101, 3999, 4000, 4001, 100_000):
            want = float(theirs(jnp.asarray(step, jnp.int32)))
            assert ours(step) == want
            assert opt.learning_rate(step) == want


@pytest.mark.parametrize("clip", [0.5, 0.0])
def test_make_optimizer_matches_jax(clip):
    P = 257
    rng = np.random.RandomState(5)
    grads = [rng.randn(P) * s for s in (0.01, 0.3, 0.02, 0.05)]
    port = topt.make_optimizer(64, 1.5, 100, grad_clip_norm=clip)
    assert isinstance(port, topt.NoamAdam)
    state_t = port.init(torch.zeros(P, dtype=torch.float64))
    with jax.enable_x64(True):
        opt = jopt.make_optimizer(64, 1.5, 100, grad_clip_norm=clip)
        state_j = opt.init(jnp.zeros(P, jnp.float64))
        for g in grads:
            u_j, state_j = opt.update(jnp.asarray(g), state_j)
            u_t = port.update(torch.from_numpy(g), state_t)
            np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-12, atol=0)


def test_features_knn_graph_matches_jax():
    from na_mpnn_tpu_torch.ops import knn

    assert tf.knn_graph is knn.knn_graph
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 40, 3)) * 6).astype(np.float32)
    mask = (rng.random((2, 40)) > 0.2).astype(np.float32)
    D_t, E_t = tf.knn_graph(torch.from_numpy(X), torch.from_numpy(mask), 12)
    D_j, E_j = jf.knn_graph(jnp.asarray(X), jnp.asarray(mask), 12)
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_j))
    np.testing.assert_allclose(D_t.numpy(), np.asarray(D_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_positional_embed_matches_jax(bias):
    rng = np.random.default_rng(1)
    mrf = 32
    offset = rng.integers(-50, 50, (2, 30, 8)).astype(np.int32)
    E_chains = rng.integers(0, 2, (2, 30, 8)).astype(np.int32)
    p = {"w": rng.standard_normal((2 * mrf + 2, 16)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(16).astype(np.float32)
    got = tf.positional_embed({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(offset), torch.from_numpy(E_chains), mrf)
    want = jf.positional_embed({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(offset), jnp.asarray(E_chains), mrf)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_features_layout_matches_jax():
    from na_mpnn_tpu_torch.models import init_params

    cfg = ModelConfig()
    ours = tf.init_features(np.random.default_rng(0), cfg)
    theirs = jax.tree.map(np.asarray, jf.init_features(jax.random.PRNGKey(0), JaxConfig()))
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [k for k, _ in flat_o] == [k for k, _ in flat_j]
    for (path, a), (_, b) in zip(flat_o, flat_j):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    for name in ("positional", "node_embedding", "edge_embedding"):
        w = ours[name]["w"]
        bound = np.sqrt(6.0 / sum(w.shape))
        assert np.abs(w).max() <= bound and np.abs(theirs[name]["w"]).max() <= bound
    np.testing.assert_array_equal(ours["positional"]["b"], 0)
    for name in ("norm_nodes", "norm_edges"):
        np.testing.assert_array_equal(ours[name]["scale"], 1)
        np.testing.assert_array_equal(ours[name]["bias"], 0)
    # init_params draws the featuriser first, from the same generator
    params = init_params(0, cfg, device="cpu")
    for (path, a) in flat_o:
        leaf = params["features"]
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_array_equal(leaf.numpy(), a, err_msg=str(path))


def test_gather_edges_and_gather_nodes_t_match_jax():
    rng = np.random.default_rng(2)
    edges = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    nodes = rng.standard_normal((2, 9, 5)).astype(np.float32)
    E_idx = rng.integers(0, 9, (2, 9, 4))
    idx_t = rng.integers(0, 9, (2, 6))
    got = tm.gather_edges(torch.from_numpy(edges), torch.from_numpy(E_idx))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.gather_edges(jnp.asarray(edges), jnp.asarray(E_idx))))
    got = tm.gather_nodes_t(torch.from_numpy(nodes), torch.from_numpy(idx_t))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.gather_nodes_t(jnp.asarray(nodes), jnp.asarray(idx_t))))


def test_reference_checkpoint_readers_match_jax(tmp_path):
    from na_mpnn_tpu.models import load_torch_checkpoint as jax_load
    from na_mpnn_tpu_torch import models, params
    from na_mpnn_tpu_torch.models import init_params

    assert models.from_torch_state_dict is params.from_torch_state_dict
    cfg = ModelConfig(hidden_dim=32, node_features=32, edge_features=32, k_neighbors=8)
    path = str(tmp_path / "m.pt")
    params.save_torch_checkpoint(path, init_params(0, cfg, device="cpu"), cfg)
    tree, meta = models.load_torch_checkpoint(path, cfg)
    jtree, jmeta = jax_load(path, JaxConfig(hidden_dim=32, node_features=32,
                                            edge_features=32, k_neighbors=8))
    assert meta == jmeta
    a, b = jax.tree_util.tree_flatten_with_path(tree)[0], \
        jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(k))


def test_data_package_exports_jax_names():
    want = {n for n in dir(jax_data) if not n.startswith("_")
            and callable(getattr(jax_data, n))}
    assert "read_cif_atoms" in want
    assert want <= set(dir(t_data))


def test_console_scripts_mirror_jax():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    data = project["tool"]["setuptools"]["package-data"]
    assert set(data["na_mpnn_tpu_torch.native"]) == {"*.cc"}
    assert set(data["na_mpnn_tpu_torch.data"]) == {"residue_library.json.gz"}
    jax_scripts = {k: v for k, v in scripts.items() if v.startswith("na_mpnn_tpu.")}
    assert len(jax_scripts) == 6
    import importlib
    for name, target in jax_scripts.items():
        ours = scripts[name.replace("na-mpnn-", "na-mpnn-torch-", 1)]
        assert ours == target.replace("na_mpnn_tpu.", "na_mpnn_tpu_torch.", 1)
        module, attr = ours.split(":")
        assert callable(getattr(importlib.import_module(module), attr)), ours

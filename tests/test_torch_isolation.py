"""The port stands alone: ``na_mpnn_tpu_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``na_mpnn_tpu``, and the
port runs its CLI (design, symmetry-tied design, score), batch design,
trainer (fp32 and the bf16 trunk), preprocessing CLI, training CLI and a
score-mode checkpoint sweep over a ``.pt`` export where neither JAX,
pandas nor networkx can be imported (networkx, which the card's machine
lacks, is imported only inside the ligand functions that need it: the
packaged residue library's topology and 1D features run without it). ``run_training`` on a gloo world of 2 CPU processes logs the
losses of a world of 1 (both on the mesh route, whose random streams are
keyed by global row, so the two split the same draws)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import ast
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np

import na_mpnn_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "na_mpnn_tpu_torch")

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
sys.modules["na_mpnn_tpu"] = None    # and so does any of the JAX package
sys.modules["pandas"] = None         # and pandas
sys.modules["networkx"] = None       # and networkx (the card's machine has none)
import na_mpnn_tpu_torch
for m in pkgutil.walk_packages(na_mpnn_tpu_torch.__path__, "na_mpnn_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from na_mpnn_tpu_torch.cli.run import cli_entry
from na_mpnn_tpu_torch.models import ModelConfig, init_params
from na_mpnn_tpu_torch.params import save_checkpoint_npz
out = sys.argv[1]
chip_smoke.write_synthetic_pdb(out + "/s.pdb", (("A", "protein", 16),
                                                ("B", "dna", 8), ("C", "rna", 6)))
save_checkpoint_npz(out + "/w.npz", init_params(0, ModelConfig(), device="cpu"))
for mode in ("design", "score"):
    cli_entry(["--mode", mode, "--checkpoint_na_mpnn", out + "/w.npz",
               "--pdb_path", out + "/s.pdb", "--out_folder", out + "/" + mode,
               "--device", "cpu", "--stats_format", "npz"])
cli_entry(["--mode", "design", "--checkpoint_na_mpnn", out + "/w.npz",
           "--pdb_path", out + "/s.pdb", "--out_folder", out + "/sym",
           "--device", "cpu", "--symmetry_residues", "B1,B2|C1,C2"])
from na_mpnn_tpu_torch.eval.batch_design import main as batch_design
with open(out + "/s.csv", "w") as f:
    f.write("structure_path\n" + out + "/s.pdb\n")
batch_design(["--csv", out + "/s.csv", "--checkpoint", out + "/w.npz",
              "--out_folder", out + "/bd", "--bucket", "16", "--device", "cpu"])
import dataclasses, torch
from na_mpnn_tpu_torch.data.pdb import parse_pdb
from na_mpnn_tpu_torch.train.collate import collate_batch
from na_mpnn_tpu_torch.train.trainer import Trainer, model_config_from_params
parsed = parse_pdb(out + "/s.pdb")
keys = ("X", "X_m", "mask", "S", "R_idx", "chain_labels", "protein_mask",
        "dna_mask", "rna_mask", "R_polymer_type")
batch = collate_batch([{k: parsed[k] for k in keys}] * 2)
cfg = dataclasses.replace(model_config_from_params({"MIXED_PRECISION": 0}),
                          hidden_dim=32, node_features=32, edge_features=32,
                          k_neighbors=8)
trainer = Trainer(cfg, seed=0, device="cpu")
gen = torch.Generator().manual_seed(0)
losses = [float(trainer.train_step(batch, gen)["loss_av"]) for _ in range(2)]
assert trainer.step == 2 and all(l == l for l in losses), losses
cfg16 = dataclasses.replace(model_config_from_params({}), hidden_dim=32,
                            node_features=32, edge_features=32, k_neighbors=8)
assert cfg16.compute_dtype == "bfloat16" and batch["S"].shape[1] % 32 == 0
trainer16 = Trainer(cfg16, seed=0, device="cpu")
loss16 = float(trainer16.train_step(batch, gen)["loss_av"])
assert loss16 == loss16 and trainer16.flat.dtype == torch.float32
import json
from na_mpnn_tpu_torch.cli.train import main as train_main
csv_path = chip_smoke.write_training_set(out + "/ds", [
    (("A", "protein", 16), ("B", "dna", 8), ("C", "dna", 8))] * 2)
with open(out + "/train.json", "w") as f:
    json.dump(chip_smoke.training_config(
        csv_path, out + "/run", HIDDEN_DIM=32, NUM_NEIGHBORS=8, NUM_ENCODER_LAYERS=1,
        NUM_DECODER_LAYERS=1, BATCH_TOKENS=100, LOSS_TOKENS=100, TOTAL_STEPS=0), f)
train_main([out + "/train.json", "--device", "cpu"])
from na_mpnn_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
initialize_distributed(1, 0, "cpu", init_file=out + "/store")
mesh_trainer = Trainer(cfg, seed=0, mesh=make_mesh(1, 1, "cpu"))
m = mesh_trainer.train_step(batch)
assert mesh_trainer.step == 1 and float(m["loss_av"]) == float(m["loss_av"])
assert tuple(m["S_pred"].shape) == tuple(batch["S"].shape)
import os
from na_mpnn_tpu_torch.cli.sweep import run_sweep
from na_mpnn_tpu_torch.params import load_params_any, save_torch_checkpoint
os.makedirs(out + "/ck")
params, _ = load_params_any(out + "/w.npz", ModelConfig(), device="cpu")
save_torch_checkpoint(out + "/ck/s_1.pt", params, ModelConfig(), meta={"step": 1})
sweep = run_sweep(out + "/ck", out + "/s.csv", "score", num_samples=2, seed=3,
                  workdir=out + "/sweep", device="cpu")
assert [e["n_orders"] for e in sweep["table"]] == [2], sweep
assert sweep["best_checkpoint"]["checkpoint"] == out + "/ck/s_1.pt"
from na_mpnn_tpu_torch.data.ligands import MolFeaturizer, ResidueLibrary, get_topology
feat = MolFeaturizer()
for raw in ResidueLibrary.standard()._raw.values():   # no networkx needed
    assert len(get_topology(raw)["bonds"]) == len(raw["bonds"])
    assert feat.embed_features_1d(raw).shape == (len(raw["atoms"]), feat.num_features_1d())
leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "na_mpnn_tpu" or m.startswith("na_mpnn_tpu.")
          or m == "pandas" or m.startswith("pandas.")
          or m == "networkx" or m.startswith("networkx.")]
assert sorted(leaked) == ["jax", "na_mpnn_tpu", "networkx", "pandas"], leaked   # the stubs
print("ISOLATED")
"""


def test_port_runs_its_cli_with_jax_unimportable(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout
    assert os.path.exists(tmp_path / "design" / "seqs" / "s.fa")
    assert os.path.exists(tmp_path / "score" / "stats" / "s.npz")
    assert os.path.exists(tmp_path / "sym" / "seqs" / "s.fa")
    assert os.path.exists(tmp_path / "bd" / "seqs" / "s.fa")
    assert os.path.exists(tmp_path / "ds" / "preprocessed" / "asmb_lengths" / "s0.npy")
    with open(tmp_path / "run" / "log.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [1]
    assert os.path.exists(tmp_path / "run" / "last.npz")
    assert os.path.exists(tmp_path / "sweep" / "s_1" / "s" / "stats" / "s.npz")


def test_run_training_on_two_ranks_logs_what_one_rank_logs(tmp_path):
    import chip_smoke
    from test_torch_mesh_workers import run_training_rank, spawn

    csv_path = chip_smoke.write_training_set(str(tmp_path / "ds"), [
        (("A", "protein", 14 + 4 * i), ("B", "dna", 8), ("C", "dna", 8))
        for i in range(3)], seed=9)
    logs = {}
    for world in (1, 2):
        base = tmp_path / f"world{world}"
        cfg = chip_smoke.training_config(
            csv_path, str(base), HIDDEN_DIM=32, NUM_NEIGHBORS=8,
            NUM_ENCODER_LAYERS=1, NUM_DECODER_LAYERS=1, BATCH_TOKENS=100,
            LOSS_TOKENS=100)
        steps = spawn(run_training_rank, world, tmp_path / f"store{world}", (cfg,))
        assert len(set(steps)) == 1 and steps[0] >= 1
        with open(base / "log.jsonl") as f:
            logs[world] = json.loads(f.readline())
    assert logs[1]["steps"] == logs[2]["steps"]
    assert np.isfinite(logs[1]["train_loss"])
    for k, v in logs[1].items():
        if k == "loader_wait_s":
            continue
        w = logs[2][k]
        if np.isnan(v):
            assert np.isnan(w), k
        else:
            assert abs(w - v) <= 1e-6 * max(abs(v), 1.0), (k, v, w)


def _imported_modules(path):
    """(absolute module name, imported inside a function) for each import of
    a source file (relative imports stay inside the package and are
    skipped)."""
    tree = ast.parse(open(path).read(), path)
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in in_function
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in in_function


# A plotting tool that never runs on the card keeps the JAX module's pandas
# imports inside its functions.
LAZY_PANDAS = {os.path.join("na_mpnn_tpu_torch", "eval", "visualize.py")}


def test_no_source_imports_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(PKG, "__init__.py")]
    for m in pkgutil.walk_packages(na_mpnn_tpu_torch.__path__,
                                   "na_mpnn_tpu_torch."):
        spec = m.module_finder.find_spec(m.name.rsplit(".", 1)[-1])
        files.append(spec.origin)
    assert len(files) > 15
    bad = []
    for f in files:
        rel = os.path.relpath(f, ROOT)
        for name, in_function in _imported_modules(f):
            root = name.split(".")[0]
            if root == "pandas" and in_function and rel in LAZY_PANDAS:
                continue
            if root in ("jax", "jaxlib", "na_mpnn_tpu", "pandas"):
                bad.append((rel, name))
            if root == "networkx" and not in_function:
                bad.append((rel, name))
    assert bad == []
    assert any(name == "pandas" for f in LAZY_PANDAS
               for name, _ in _imported_modules(os.path.join(ROOT, f)))

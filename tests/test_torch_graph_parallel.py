"""The port's edge-partitioned forward (``parallel/graph_parallel.py``) on
gloo meshes of CPU processes against the JAX package's single-device
``forward`` (``kernels="xla"``, float64): at meshes (1,2), (1,4) and (2,2),
B=2, L=64, full width (H=128, K=32, 3+3 layers), dropout 0 and a given decode
order, the log-probs and the gradient of every parameter of a scalar of
them agree within 1e-8, in ``rbf_mode`` classed and dense (the JAX
contract, ``graph_parallel.py:24-25``). The ranks run in their own
processes (``test_torch_mesh_workers.py``, which imports no JAX); the JAX
reference runs here. Also the statistics of the row-keyed random streams."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from na_mpnn_tpu.models import ModelConfig as JaxConfig
from na_mpnn_tpu.models import forward as jax_forward
from na_mpnn_tpu.models import init_params as jax_init

from na_mpnn_tpu_torch.parallel import graph_parallel as gp
from ref_oracle import make_synthetic_structure
import test_torch_mesh_workers as workers
from test_torch_mesh_workers import spawn

ATOL = 1e-8
B, L = 2, 64


@pytest.fixture(scope="module")
def reference():
    """Batch, parameters, decode order, cotangent R and the JAX log-probs
    and flat gradient of ``sum(log_probs * R)``."""
    parts = [make_synthetic_structure(L=L, seed=s, n_protein=28, n_dna=24)
             for s in (11, 12)]
    b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    b["X"] = b["X"].astype(np.float64)
    b["mask"][1, -6:] = 0          # masked rows on the last shard
    rng = np.random.RandomState(9)
    order = np.stack([rng.permutation(L) for _ in range(B)])
    R = rng.randn(B, L, 33)
    with jax.enable_x64(True):
        cfg = JaxConfig(kernels="xla", dropout=0.0)
        params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                              jax_init(jax.random.PRNGKey(3), cfg))
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        bj["decoding_order"] = jnp.asarray(order)

        def f(p):
            lp = jax_forward(p, cfg, bj)[0]
            return jnp.sum(lp * R), lp

        (_, lp), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree.map(jnp.asarray, params))
        flat = np.concatenate([np.asarray(g).reshape(-1)
                               for g in jax.tree.leaves(grads)])
    return b, params, order, R, np.asarray(lp), flat


@pytest.mark.parametrize("data,graph", [(1, 2), (1, 4), (2, 2)])
def test_forward_graph_parallel_matches_jax_forward(reference, tmp_path, data,
                                                    graph):
    b, params, order, R, lp_j, grad_j = reference
    res = spawn(workers.forward_and_grads, data * graph, tmp_path / "store",
                (data, graph, params, b, order, R, ("classed", "dense"),
                 {"dropout": 0.0}))
    for mode in ("classed", "dense"):
        lp = np.full((B, L, 33), np.nan)
        for rank, out in enumerate(res):
            d, g = divmod(rank, graph)
            lp[d * B // data:(d + 1) * B // data,
               g * L // graph:(g + 1) * L // graph] = out[mode][0]
        np.testing.assert_allclose(lp, lp_j, atol=ATOL, rtol=0, err_msg=mode)
        for out in res:     # the world-summed gradient, on every rank
            np.testing.assert_allclose(out[mode][1], grad_j, atol=ATOL, rtol=0,
                                       err_msg=mode)
    assert np.abs(grad_j).max() > 1e-3


def test_no_grad_forward_graph_parallel_takes_fused_route(reference, tmp_path):
    """Under no gradient the edge-partitioned forward runs the fused layer
    updates on the all-gathered tables (never the message table), and at
    mesh (1,2) equals the one-device ``forward`` and JAX within 1e-8."""
    from na_mpnn_tpu_torch.models import ModelConfig, forward
    from na_mpnn_tpu_torch.params import from_jax_params

    b, params, order, _, lp_j, _ = reference
    res = spawn(workers.forward_no_grad, 2, tmp_path / "store",
                (1, 2, params, b, order, {"dropout": 0.0}))
    lp = np.concatenate([out[0] for out in res], axis=1)
    for _, calls in res:
        assert calls == {"fused_node_update_plain": 6,
                         "fused_edge_update_plain": 3}
    with torch.no_grad():
        lp_1 = forward(from_jax_params(params, device="cpu", dtype=torch.float64),
                       ModelConfig(dropout=0.0),
                       {**{k: torch.from_numpy(v) for k, v in b.items()},
                        "decoding_order": torch.from_numpy(order)})[0].numpy()
    np.testing.assert_allclose(lp, lp_1, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lp, lp_j, atol=ATOL, rtol=0)


def test_row_streams_statistics_and_partition_invariance():
    """Dropout keeps 1 - rate of the entries and scales them by 1/keep;
    the noise is standard normal; the streams of a row block equal the
    rows of the whole (the partition never enters); tags, steps and seeds
    give other streams."""
    rid = torch.arange(2 * 600).view(2, 600)
    x = torch.full((2, 600, 256), 3.0, dtype=torch.float64)
    rate, keep = 0.2, 0.8
    y = gp.row_dropout(rate, (7, 3), 200, rid)(x, 1)
    kept = y != 0
    n = kept.numel()
    assert abs(float(kept.double().mean()) - keep) < 4 * math.sqrt(keep * rate / n)
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 3.0 / keep,
                                           dtype=torch.float64))
    # a block of rows draws what those rows draw in the whole
    y_block = gp.row_dropout(rate, (7, 3), 200, rid[:, 150:300])(x[:, 150:300], 1)
    assert torch.equal(y_block, y[:, 150:300])
    for other in (gp.row_dropout(rate, (7, 3), 201, rid)(x, 1),
                  gp.row_dropout(rate, (7, 4), 200, rid)(x, 1),
                  gp.row_dropout(rate, (8, 3), 200, rid)(x, 1)):
        assert not torch.equal(other != 0, kept)
    assert gp.row_dropout(rate, None, 200, rid)(x, 1) is x
    assert gp.row_dropout(0.0, (7, 3), 200, rid)(x, 1) is x

    z = gp.row_normal((7, 3), gp.TAG_NOISE, rid, (16, 3), torch.float64)
    assert z.shape == (2, 600, 16, 3)
    n = z.numel()
    assert abs(float(z.mean())) < 4 / math.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 4 * math.sqrt(2.0 / n)
    assert torch.equal(gp.row_normal((7, 3), gp.TAG_NOISE, rid[:, :40], (16, 3),
                                     torch.float64), z[:, :40])
    u = gp.row_uniform((1, 0), 5, rid, 64, torch.float64)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / u.numel())

"""Rank workers of the port's multi-process tests (``test_torch_graph_
parallel.py``, ``test_torch_mesh_train.py``, ``test_torch_bf16_mesh.py``)
and ``spawn``, which runs one
on a gloo mesh of CPU processes. The workers import only ``torch``, numpy
and the port; the JAX reference runs in the parent. This module holds no
tests."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import collections
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from na_mpnn_tpu_torch.models import ModelConfig
from na_mpnn_tpu_torch.params import from_jax_params
from na_mpnn_tpu_torch.parallel.graph_parallel import forward_graph_parallel
from na_mpnn_tpu_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                             shard_batch, sync_batch_length)
from na_mpnn_tpu_torch.train.collate import repad_length
from na_mpnn_tpu_torch.train.trainer import Trainer, tree_leaves

TIMEOUT_S = 300


def _entry(fn, rank, world_size, init_file, args, results):
    try:
        initialize_distributed(world_size, rank, "cpu", init_file)
        value = fn(rank, *args)
        dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the rank's failure, reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size, init_file, args=()):
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (``spawn``
    start method), each in a gloo group started from a ``FileStore`` at
    ``init_file`` (a path that does not exist yet); return the ranks' values
    in rank order. A rank that raises makes this raise with its traceback;
    the other ranks, which would wait on it in a collective, are stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, str(init_file),
                                              args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"mesh of {world_size}: no result in "
                                   f"{TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world_size else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world_size)]


def _rows(mesh, batch_np, arr):
    """This rank's rows of a ``[B, L, ...]`` array, all residues."""
    return shard_batch({"S": batch_np["S"], "a": arr}, mesh,
                       shard_length=False)["a"]


def forward_and_grads(rank, data, graph, params_np, batch_np, order, R, modes,
                      cfg_kw):
    """Per ``rbf_mode``: this rank's deterministic log-probs (decode order
    ``order``) and the world-summed flat gradient of ``sum(log_probs * R)``,
    at float64."""
    torch.set_num_threads(1)
    mesh = make_mesh(data, graph, device="cpu")
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch_np, mesh).items()}
    order_rows = torch.from_numpy(_rows(mesh, batch_np, order))
    R_local = torch.from_numpy(shard_batch({"S": batch_np["S"], "R": R}, mesh)["R"])
    out = {}
    for mode in modes:
        params = from_jax_params(params_np, device="cpu", dtype=torch.float64)
        leaves = list(tree_leaves(params))
        for leaf in leaves:
            leaf.requires_grad_(True)
        lp = forward_graph_parallel(params, ModelConfig(rbf_mode=mode, **cfg_kw),
                                    local, mesh, order_rows)
        (lp * R_local).sum().backward()
        g = torch.cat([leaf.grad.reshape(-1) for leaf in leaves])
        dist.all_reduce(g)
        out[mode] = (lp.detach().numpy(), g.numpy())
    return out


def forward_no_grad(rank, data, graph, params_np, batch_np, order, cfg_kw):
    """This rank's deterministic log-probs under no gradient (decode order
    ``order``, float64) and the calls of each layer route's plain function
    (the fused updates, the message table)."""
    from na_mpnn_tpu_torch.ops import fused_layers as fl
    from na_mpnn_tpu_torch.ops import message_kernels as mk

    calls = collections.Counter()

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        setattr(mod, name, wrapper)

    for mod, name in ((fl, "fused_node_update_plain"),
                      (fl, "fused_edge_update_plain"),
                      (mk, "message_table_plain")):
        counted(mod, name)
    torch.set_num_threads(1)
    mesh = make_mesh(data, graph, device="cpu")
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch_np, mesh).items()}
    order_rows = torch.from_numpy(_rows(mesh, batch_np, order))
    params = from_jax_params(params_np, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        lp = forward_graph_parallel(params, ModelConfig(**cfg_kw), local, mesh,
                                    order_rows)
    return lp.numpy(), dict(calls)


def trainer_loss_and_grads(rank, data, graph, batch_np, cfg_kw, trainer_kw):
    """One training loss and its flat gradient (dropout, noise and the decode
    order from the row-keyed streams) of a float64 mesh ``Trainer``."""
    torch.set_num_threads(1)
    mesh = make_mesh(data, graph, device="cpu")
    tr = Trainer(ModelConfig(**cfg_kw), mesh=mesh, device="cpu",
                 dtype=torch.float64, **trainer_kw)
    loss, grad = tr.loss_and_grads(tr.device_batch(batch_np))[:2]
    return float(loss), grad.numpy()


def trainer_step(rank, data, graph, batch_np, cfg_kw, trainer_kw, ckpt):
    """The flat gradient of one step, one ``train_step`` (fp32) and its
    metrics; then ``save`` on rank 0 and ``restore`` on every rank, checked
    bitwise here."""
    torch.set_num_threads(1)
    mesh = make_mesh(data, graph, device="cpu")
    # ranks that collate their own rows to other lengths agree on the longest
    longer = sync_batch_length(repad_length(batch_np, 64 + 32 * rank), mesh)
    synced = longer["S"].shape == (2, 32 + 32 * mesh.size)
    cfg = ModelConfig(**cfg_kw)
    tr = Trainer(cfg, mesh=mesh, device="cpu", **trainer_kw)
    grad = tr.loss_and_grads(tr.device_batch(batch_np))[1]
    m = tr.train_step(batch_np)
    tr.save(ckpt, epoch=1, save_step=0)
    back = Trainer(cfg, mesh=mesh, device="cpu", **{**trainer_kw, "seed": 5})
    back.restore(ckpt)
    s, r = tr.opt_state, back.opt_state
    same = bool(torch.equal(tr.flat, back.flat) and torch.equal(s.mu, r.mu)
                and torch.equal(s.nu, r.nu) and s.count == r.count
                and back.step == tr.step == 1)
    return {"grad": grad.numpy(), "flat": tr.flat.numpy().copy(),
            "offsets": np.cumsum([0] + [p.numel() for p in tr.leaves]),
            "metrics": {k: v.numpy() for k, v in m.items()},
            "restored": same, "synced": synced}


def _record_layer_dtypes(dtypes):
    """Record (layer kind, dtype of ``h_V``) of every layer the graph-parallel
    forward runs."""
    from na_mpnn_tpu_torch.parallel import graph_parallel as gp

    for name in ("enc_layer", "dec_layer"):
        fn = getattr(gp, name)

        def wrapper(p, h_V, *a, _fn=fn, _name=name, **kw):
            dtypes.add((_name, str(h_V.dtype)))
            return _fn(p, h_V, *a, **kw)
        setattr(gp, name, wrapper)


def mesh_steps(rank, data, graph, batch_np, cfg_kws, trainer_kw):
    """Per config of ``cfg_kws``: one loss and its flat gradient of an
    fp32-parameter mesh ``Trainer`` (the decode order from
    ``batch_np["decoding_order"]``) and the (layer, ``h_V`` dtype) pairs of
    its layers."""
    torch.set_num_threads(1)
    dtypes = set()
    _record_layer_dtypes(dtypes)
    mesh = make_mesh(data, graph, device="cpu")
    out = []
    for cfg_kw in cfg_kws:
        dtypes.clear()
        tr = Trainer(ModelConfig(**cfg_kw), mesh=mesh, device="cpu", **trainer_kw)
        loss, grad = tr.loss_and_grads(tr.device_batch(batch_np))[:2]
        out.append((float(loss), grad.numpy(), sorted(dtypes)))
    return out


def mesh_features(rank, data, graph, batch_np, order, cfg_kws, params_np):
    """Per config of ``cfg_kws``: this rank's deterministic
    ``forward_graph_parallel`` (no gradient; the fp32 parameters of the JAX
    tree ``params_np``), its log-probs ``lp`` and, inside it, the RBF
    projection and the ``low`` it was called with, and the featuriser's edge
    features, ``E_idx`` and ``low_pos``."""
    from na_mpnn_tpu_torch.ops import rbf_classed, rbf_edge
    from na_mpnn_tpu_torch.parallel import graph_parallel as gp

    torch.set_num_threads(1)
    seen = {}
    for mod, name in ((rbf_classed, "rbf_edge_features_classed_qk"),
                      (rbf_edge, "rbf_edge_features_qk")):
        fn = getattr(mod, name)

        def rbf(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            seen.update(rbf=out.numpy(), low=kw.get("low"))
            return out
        setattr(mod, name, rbf)
    feats = gp.features_from_coords

    def features(*a, **kw):
        out = feats(*a, **kw)
        seen.update(E=out[1].numpy(), E_idx=out[2].numpy(),
                    low_pos=kw.get("low_pos"))
        return out
    gp.features_from_coords = features
    mesh = make_mesh(data, graph, device="cpu")
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch_np, mesh).items()}
    order_rows = torch.from_numpy(_rows(mesh, batch_np, order))
    params = from_jax_params(params_np, device="cpu")
    out = []
    for cfg_kw in cfg_kws:
        seen.clear()
        with torch.no_grad():
            lp = forward_graph_parallel(params, ModelConfig(**cfg_kw), local, mesh,
                                        order_rows)
        out.append(dict(seen, lp=lp.numpy()))
    return out


def run_training_rank(rank, cfg):
    """This rank of ``run_training`` (one epoch on the CPU) on the
    initialised gloo world: a (world, 1) mesh, every rank loading the whole
    batch, rank 0 writing the logs. Returns the trainer's step."""
    from na_mpnn_tpu_torch.train.trainer import run_training

    torch.set_num_threads(1)
    return run_training(cfg, max_epochs=1, device="cpu").step


def run_training_dtype_rank(rank, cfg):
    """``run_training_rank``, returning (the trainer's step, its
    ``compute_dtype``)."""
    from na_mpnn_tpu_torch.train.trainer import run_training

    torch.set_num_threads(1)
    tr = run_training(cfg, max_epochs=1, device="cpu")
    return tr.step, tr.cfg.compute_dtype


def sampler_cases(rank, data, graph, params_np, b_np, order, gumbel, bias,
                  pair_np, cfg_kw, fwd):
    """The graph-parallel sampler (``sample_graph_parallel``, float64) on
    this rank of a (data, graph) mesh, each case beside the one-device
    ``sample`` where it has one:

    * ``"given"``: the decode order ``order`` and the per-step noise
      ``gumbel`` given (JAX's, compared in the parent);
    * ``"generator"``: order and noise drawn from a ``torch.Generator``
      (seed 7), and ``sample`` with the same seed;
    * ``"bias"``: a per-position bias and a pair bias (seed 9), and
      ``sample`` with them.

    Also, with ``fwd = (batch, order, R)``, the chunked graph-parallel
    forward (``gp_knn_key_chunk=24``, ``gp_rbf_row_chunk=5``): this rank's
    log-probs and the world-summed gradient of ``sum(log_probs * R)``."""
    from na_mpnn_tpu_torch.models import sample
    from na_mpnn_tpu_torch.parallel.graph_parallel import sample_graph_parallel

    torch.set_num_threads(1)
    mesh = make_mesh(data, graph, device="cpu")
    cfg = ModelConfig(**cfg_kw)
    params = from_jax_params(params_np, device="cpu", dtype=torch.float64)
    b = {k: torch.from_numpy(v) for k, v in b_np.items()}
    B = order.shape[0]

    def numpy(out):
        return {k: v.numpy() for k, v in out.items()}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    out = {"given": numpy(sample_graph_parallel(
        params, cfg, {**b, "decoding_order": torch.from_numpy(order)}, None,
        mesh, num_samples=B, temperature=0.5, gumbel=torch.from_numpy(gumbel)))}
    out["generator"] = tuple(numpy(fn(params, cfg, b, gen(7), *m, num_samples=3,
                                      temperature=0.6))
                             for fn, m in ((sample_graph_parallel, (mesh,)),
                                           (sample, ())))
    pair = {k: torch.from_numpy(v) for k, v in pair_np.items()}
    out["bias"] = tuple(numpy(fn(params, cfg, b, gen(9), *m, num_samples=2,
                                 temperature=0.5, bias=torch.from_numpy(bias),
                                 pair_bias_ctx=pair))
                        for fn, m in ((sample_graph_parallel, (mesh,)),
                                      (sample, ())))

    batch_np, order_f, R = fwd
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch_np, mesh).items()}
    R_local = torch.from_numpy(shard_batch({"S": batch_np["S"], "R": R}, mesh)["R"])
    leaves = list(tree_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    lp = forward_graph_parallel(
        params, ModelConfig(**cfg_kw, gp_knn_key_chunk=24, gp_rbf_row_chunk=5),
        local, mesh, torch.from_numpy(_rows(mesh, batch_np, order_f)))
    (lp * R_local).sum().backward()
    g = torch.cat([leaf.grad.reshape(-1) for leaf in leaves])
    dist.all_reduce(g)
    out["forward"] = (lp.detach().numpy(), g.numpy())
    return out


def run_training_params(rank, cfg):
    """``run_training_rank``, returning (the trainer's step, whether it took
    the per-host feed, its flat parameters)."""
    from na_mpnn_tpu_torch.train.trainer import run_training

    torch.set_num_threads(1)
    tr = run_training(cfg, max_epochs=1, device="cpu")
    return tr.step, tr.per_host_feed, tr.flat.detach().numpy().copy()

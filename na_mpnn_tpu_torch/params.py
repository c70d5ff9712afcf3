"""Parameters: the JAX package's ``.npz`` checkpoint layout and reference
``.pt`` state_dicts, both ways.

The port's own copy of the JAX package's ``models/torch_import.py``
(``from_torch_state_dict``, ``to_torch_state_dict``) and of the ``.npz``
and ``.pt`` halves of ``train/checkpoint.py`` (``flatten_pytree``,
``unflatten_pytree``, ``save_checkpoint_npz``, ``load_checkpoint_npz``,
``load_params_any``, ``save_torch_checkpoint``).

The port's tree has the JAX package's nesting and key names (dicts and
lists) with ``torch.Tensor`` leaves, and linear weights in the JAX layout
``[in, out]``: no transposes between the two packages. A reference
state_dict stores ``nn.Linear`` weights ``[out, in]``; ``from_torch_state_dict``
transposes every linear weight (not the token embedding) on the way in and
``to_torch_state_dict`` on the way out. Orbax directory checkpoints are
refused: ``orbax.checkpoint`` imports ``jax``, which the port never does.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.config import ModelConfig

_SEP = "/"


def flatten_pytree(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}{_SEP}"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_pytree(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_checkpoint_npz(path: str) -> Tuple[Any, Dict, Dict[str, np.ndarray]]:
    """(params tree of numpy arrays, meta, optimizer leaves) of an ``.npz``
    checkpoint written by either package."""
    data = dict(np.load(path, allow_pickle=False))
    meta = json.loads(bytes(data.pop("__meta__").tolist()).decode()) \
        if "__meta__" in data else {}
    params_flat = {k[len("params" + _SEP):]: v for k, v in data.items()
                   if k.startswith("params" + _SEP)}
    opt_flat = {k[len("opt" + _SEP):]: v for k, v in data.items()
                if k.startswith("opt" + _SEP)}
    return unflatten_pytree(params_flat), meta, opt_flat


def save_checkpoint_npz(path: str, params, meta: Optional[Dict] = None,
                        opt_state_flat: Optional[Dict[str, np.ndarray]] = None):
    """Write ``params`` (tensor or numpy leaves), and the optimizer leaves
    where given (``opt/leaf0000``...), in the ``.npz`` layout that both
    packages read."""
    flat = {"params" + _SEP + k: v for k, v in flatten_pytree(params).items()}
    if opt_state_flat:
        flat.update({"opt" + _SEP + k: v for k, v in opt_state_flat.items()})
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                     dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def from_jax_params(tree, device="cuda", dtype=torch.float32):
    """JAX parameter tree (nested dicts/lists of arrays, as
    ``unflatten_pytree`` gives it) -> the same tree of tensors on ``device``.
    Floating leaves take ``dtype``; the layout is unchanged."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, order="C"))   # a writable C-order copy
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _np(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping, prefix: str):
    p = {"w": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _norm(sd: Mapping, prefix: str):
    return {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}


def _pff(sd: Mapping, prefix: str):
    return {"W_in": _linear(sd, prefix + ".W_in"),
            "W_out": _linear(sd, prefix + ".W_out")}


def from_torch_state_dict(sd: Mapping, cfg: ModelConfig):
    """Reference ``model_state_dict`` -> JAX-layout tree of numpy arrays
    (linear weights transposed to ``[in, out]``)."""
    def enc(prefix):
        p = {n: _linear(sd, f"{prefix}.{n}")
             for n in ["W1", "W2", "W3", "W11", "W12", "W13"]}
        for n in ["norm1", "norm2", "norm3"]:
            p[n] = _norm(sd, f"{prefix}.{n}")
        p["dense"] = _pff(sd, prefix + ".dense")
        return p

    def dec(prefix):
        p = {n: _linear(sd, f"{prefix}.{n}") for n in ["W1", "W2", "W3"]}
        for n in ["norm1", "norm2"]:
            p[n] = _norm(sd, f"{prefix}.{n}")
        p["dense"] = _pff(sd, prefix + ".dense")
        return p

    return {
        "features": {
            "positional": _linear(sd, "features.embeddings.linear"),
            "node_embedding": _linear(sd, "features.node_embedding"),
            "norm_nodes": _norm(sd, "features.norm_nodes"),
            "edge_embedding": _linear(sd, "features.edge_embedding"),
            "norm_edges": _norm(sd, "features.norm_edges"),
        },
        "W_v": _linear(sd, "W_v"),
        "W_e": _linear(sd, "W_e"),
        "W_s": {"emb": _np(sd["W_s.weight"])},
        "W_out": _linear(sd, "W_out"),
        "encoder": [enc(f"encoder_layers.{i}")
                    for i in range(cfg.num_encoder_layers)],
        "decoder": [dec(f"decoder_layers.{i}")
                    for i in range(cfg.num_decoder_layers)],
    }


def refuse_orbax(path: str):
    """Raise for an orbax directory checkpoint, saying why."""
    raise NotImplementedError(
        f"{path}: orbax directory checkpoints are refused: orbax.checkpoint "
        "imports jax, which this package never imports; write the "
        "checkpoint as .npz or .pt")


def load_params_any(path: str, cfg: ModelConfig, device="cuda",
                    dtype=torch.float32):
    """Parameters from an ``.npz`` (JAX layout) or a reference ``.pt``
    checkpoint -> (tensor tree on ``device``, meta). An orbax directory
    raises (``refuse_orbax``)."""
    if os.path.isdir(path):
        refuse_orbax(path)
    if path.endswith((".pt", ".pth")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
        meta = {k: ckpt[k] for k in ("epoch", "step", "save_step") if k in ckpt}
        tree = from_torch_state_dict(sd, cfg)
    else:
        tree, meta, _ = load_checkpoint_npz(path)
    return from_jax_params(tree, device=device, dtype=dtype), meta


def to_torch_state_dict(params, cfg: ModelConfig):
    """The port's (or the JAX package's) parameter tree, on any device ->
    the reference state_dict layout (numpy arrays; ``[out, in]`` linear
    weights, the token embedding as it is). Inverse of
    ``from_torch_state_dict``."""
    sd = {}

    def put_linear(prefix, p):
        sd[prefix + ".weight"] = _np(p["w"]).T
        if "b" in p:
            sd[prefix + ".bias"] = _np(p["b"])

    def put_norm(prefix, p):
        sd[prefix + ".weight"] = _np(p["scale"])
        sd[prefix + ".bias"] = _np(p["bias"])

    f = params["features"]
    put_linear("features.embeddings.linear", f["positional"])
    put_linear("features.node_embedding", f["node_embedding"])
    put_norm("features.norm_nodes", f["norm_nodes"])
    put_linear("features.edge_embedding", f["edge_embedding"])
    put_norm("features.norm_edges", f["norm_edges"])
    put_linear("W_v", params["W_v"])
    put_linear("W_e", params["W_e"])
    sd["W_s.weight"] = _np(params["W_s"]["emb"])
    put_linear("W_out", params["W_out"])
    for i, lp in enumerate(params["encoder"]):
        for name in ["W1", "W2", "W3", "W11", "W12", "W13"]:
            put_linear(f"encoder_layers.{i}.{name}", lp[name])
        for name in ["norm1", "norm2", "norm3"]:
            put_norm(f"encoder_layers.{i}.{name}", lp[name])
        put_linear(f"encoder_layers.{i}.dense.W_in", lp["dense"]["W_in"])
        put_linear(f"encoder_layers.{i}.dense.W_out", lp["dense"]["W_out"])
    for i, lp in enumerate(params["decoder"]):
        for name in ["W1", "W2", "W3"]:
            put_linear(f"decoder_layers.{i}.{name}", lp[name])
        for name in ["norm1", "norm2"]:
            put_norm(f"decoder_layers.{i}.{name}", lp[name])
        put_linear(f"decoder_layers.{i}.dense.W_in", lp["dense"]["W_in"])
        put_linear(f"decoder_layers.{i}.dense.W_out", lp["dense"]["W_out"])
    return sd


def save_torch_checkpoint(path: str, params, cfg: ModelConfig,
                          meta: Optional[Dict] = None):
    """Write ``params`` as a reference ``.pt`` checkpoint:
    ``{**meta, "model_state_dict": ...}`` with contiguous CPU float32
    tensors."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in to_torch_state_dict(params, cfg).items()}
    payload = dict(meta or {})
    payload["model_state_dict"] = sd
    torch.save(payload, path)

"""Random weights of a LigandMPNN configuration in LigandMPNN's own state-
dict layout (the names and shapes of ``ligandmpnn_v_32_010_25.pt``), made
on the device from the seed in one draw, as ``weights.make`` draws them
(weights uniform in +-sqrt(6 / (fan_in + fan_out)), biases in +-0.1,
LayerNorm scales in 1 +- 0.2 and offsets in +-0.1, the token embedding of
unit variance)."""
from __future__ import annotations

import math

import torch

ELEMENT_FEATURES = 147


def shapes(cfg: dict):
    """(name, shape, kind) of every tensor of ``cfg`` (the configuration
    file's keys)."""
    H, bins = cfg["HIDDEN_DIM"], cfg["NUM_RBF"]
    n_pos = cfg["NUM_POSITIONAL_EMBEDDINGS"]
    out = []

    def lin(name, d_in, d_out, bias=True):
        out.append((name + ".weight", (d_out, d_in), "weight"))
        if bias:
            out.append((name + ".bias", (d_out,), "bias"))

    def norm(name):
        out.extend([(name + ".weight", (H,), "scale"), (name + ".bias", (H,), "offset")])

    lin("features.embeddings.linear", 2 * cfg["MAX_RELATIVE_FEATURE"] + 2, n_pos)
    lin("features.edge_embedding", n_pos + 25 * bins, H, bias=False)
    norm("features.norm_edges")
    lin("features.node_project_down", 5 * bins + 64 + 4, H)
    norm("features.norm_nodes")
    lin("features.type_linear", ELEMENT_FEATURES, 64)
    lin("features.y_nodes", ELEMENT_FEATURES, H, bias=False)
    lin("features.y_edges", bins, H, bias=False)
    norm("features.norm_y_edges")
    norm("features.norm_y_nodes")
    for name in ("W_e", "W_v", "W_c", "W_nodes_y", "W_edges_y"):
        lin(name, H, H)
    lin("V_C", H, H, bias=False)
    norm("V_C_norm")
    out.append(("W_s.weight", (cfg["VOCAB_SIZE"], H), "embedding"))
    lin("W_out", H, cfg["NUM_LETTERS"])

    def layer(prefix, d_in, edge=False):
        for n in ("W1", "W2", "W3") + (("W11", "W12", "W13") if edge else ()):
            lin(f"{prefix}.{n}", d_in if n in ("W1", "W11") else H, H)
        for n in ("norm1", "norm2") + (("norm3",) if edge else ()):
            norm(f"{prefix}.{n}")
        lin(f"{prefix}.dense.W_in", H, 4 * H)
        lin(f"{prefix}.dense.W_out", 4 * H, H)

    for i in range(cfg["NUM_ENCODER_LAYERS"]):
        layer(f"encoder_layers.{i}", 3 * H, edge=True)
    for i in range(cfg["NUM_DECODER_LAYERS"]):
        layer(f"decoder_layers.{i}", 4 * H)
    for i in range(cfg["NUM_CONTEXT_LAYERS"]):
        layer(f"context_encoder_layers.{i}", 3 * H)
        layer(f"y_context_encoder_layers.{i}", 2 * H)
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The state dict of ``cfg`` for ``seed``: one ``torch.rand`` on
    ``device`` from a generator there, cut and scaled."""
    rows = shapes(cfg)
    sizes = [math.prod(s) for _, s, _ in rows]
    gen = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2 ** 63)
    u = 2.0 * torch.rand(sum(sizes), generator=gen, device=device) - 1.0
    sd, at = {}, 0
    for (name, shape, kind), n in zip(rows, sizes):
        x = u[at:at + n].view(shape)
        at += n
        if kind == "weight":
            x = x * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif kind in ("bias", "offset"):
            x = 0.1 * x
        elif kind == "scale":
            x = 1.0 + 0.2 * x
        else:
            x = math.sqrt(3.0) * x
        sd[name] = x.contiguous()
    return sd

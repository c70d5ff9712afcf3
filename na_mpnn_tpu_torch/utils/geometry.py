"""Geometry utilities: planar angles, dihedrals, local frames, triple product.

The port's counterpart of the JAX package's ``utils/geometry.py``, on torch
tensors: each function computes in its inputs' dtype and on their device.
"""
from __future__ import annotations

import torch


def _unit(v, eps):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def get_ang(a, b, c, eps: float = 1e-8):
    """Planar angle at b formed by points a-b-c ([..., 3] each) -> radians."""
    v = _unit(a - b, eps)
    w = _unit(c - b, eps)
    # atan2 is stable near 0 and pi, where acos of the dot is not.
    y = torch.linalg.vector_norm(torch.linalg.cross(v, w), dim=-1)
    x = torch.sum(v * w, dim=-1)
    return torch.atan2(y, x)


def get_dih(a, b, c, d, eps: float = 1e-8):
    """Dihedral angle around the b-c axis for points a-b-c-d -> radians."""
    b0 = a - b
    b1 = _unit(c - b, eps)
    b2 = d - c
    v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
    w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1
    x = torch.sum(v * w, dim=-1)
    y = torch.sum(torch.linalg.cross(b1, v) * w, dim=-1)
    return torch.atan2(y, x)


def get_frames(n, ca, c, eps: float = 1e-8):
    """Orthonormal residue frames from backbone N/CA/C ([..., 3] each)
    -> rotation matrices [..., 3, 3] with rows (x, y, z)."""
    e1 = _unit(c - ca, eps)
    v2 = n - ca
    e2 = _unit(v2 - torch.sum(e1 * v2, dim=-1, keepdim=True) * e1, eps)
    e3 = torch.linalg.cross(e1, e2)
    return torch.stack([e1, e2, e3], dim=-2)


def triple_prod(a, b, c):
    """Scalar triple product a . (b x c) over the last axis."""
    return torch.sum(a * torch.linalg.cross(b, c), dim=-1)

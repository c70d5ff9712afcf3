"""The port's geometry utilities (``na_mpnn_tpu_torch/utils/geometry.py``)
against the JAX package's on the same seeded inputs: float32 within 1e-6,
float64 (JAX with x64 for the call) within 1e-12; each result in its
input's dtype."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import na_mpnn_tpu.utils.geometry as jg
import na_mpnn_tpu_torch.utils.geometry as tg

# (function name, number of [..., 3] point arguments)
FUNCTIONS = [("get_ang", 3), ("get_dih", 4), ("get_frames", 3), ("triple_prod", 3)]


def _points(n_args, dtype, seed):
    rng = np.random.default_rng(seed)
    pts = [rng.standard_normal((4, 37, 3)) * 3.0 for _ in range(n_args)]
    # degenerate rows: coincident points, collinear points
    pts[1][0, 0] = pts[0][0, 0]
    pts[2][0, 1] = pts[0][0, 1] + 2.0 * (pts[1][0, 1] - pts[0][0, 1])
    return [p.astype(dtype) for p in pts]


@pytest.mark.parametrize("name,n_args", FUNCTIONS)
def test_float32_matches_jax(name, n_args):
    pts = _points(n_args, np.float32, seed=n_args)
    got = getattr(tg, name)(*[torch.from_numpy(p) for p in pts])
    want = np.asarray(getattr(jg, name)(*[jnp.asarray(p) for p in pts]))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,n_args", FUNCTIONS)
def test_float64_matches_jax(name, n_args):
    pts = _points(n_args, np.float64, seed=10 + n_args)
    got = getattr(tg, name)(*[torch.from_numpy(p) for p in pts])
    with jax.enable_x64(True):
        want = np.asarray(getattr(jg, name)(*[jnp.asarray(p) for p in pts]))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_frames_are_rotations():
    pts = [torch.from_numpy(p) for p in _points(3, np.float64, seed=3)]
    R = tg.get_frames(*[p[1:] for p in pts])
    # orthonormal up to the eps (1e-8) added to each norm
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(R.shape[:-2],
                                                             dtype=torch.float64),
                               rtol=0, atol=1e-6)

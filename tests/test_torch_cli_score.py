"""The port's CLI in specificity and score mode against the JAX package's
CLI (see ``test_torch_cli.py``; split so the two files run side by side)."""
import torch_threads  # noqa: F401  (one share of the cores per xdist worker)
import pytest

from test_torch_cli import compare_with_jax_cli, inputs  # noqa: F401 (fixture)


@pytest.mark.parametrize("mode", ["specificity", "score"])
def test_cli_outputs_match_jax_cli(inputs, mode):  # noqa: F811
    compare_with_jax_cli(inputs, mode)

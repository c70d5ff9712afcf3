"""Training CLI: ``python -m na_mpnn_tpu_torch.cli.train config.json
[--device cuda|cpu]``.

The JSON schema is the JAX package's (the reference training configs plus
``SEED``, ``MESH_GRAPH_AXIS``, ``NUM_WORKERS``, ``PROFILE_DIR``).
``MIXED_PRECISION`` defaults to 1, as in the JAX package: the bf16 trunk,
on one device and on a mesh; ``MIXED_PRECISION: 0`` trains in fp32.
Runs on the card unless ``--device cpu`` is given. Under ``torchrun`` every
process trains one rank of a ``(WORLD_SIZE / MESH_GRAPH_AXIS,
MESH_GRAPH_AXIS)`` mesh.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m na_mpnn_tpu_torch.cli.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="training config (JSON)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    from ..train.trainer import run_training
    run_training(args.config, device=args.device)


if __name__ == "__main__":
    main()

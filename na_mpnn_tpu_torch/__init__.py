"""NA-MPNN in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The package mirrors the module layout and public names of the JAX package
``na_mpnn_tpu`` (the reference it is tested against) and imports nothing of
it. Entry points run on ``cuda`` unless the caller asks for ``cpu``; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"

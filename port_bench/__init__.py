"""The benchmark of ``na_mpnn_tpu_torch`` (``python3 -m port_bench.run``;
see ``README.md``)."""

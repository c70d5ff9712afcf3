"""Multi-device training on ``torch.distributed``: the (data, graph) mesh
and the edge-partitioned forward (port of the JAX package's
``parallel/``)."""

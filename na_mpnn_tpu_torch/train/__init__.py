"""Training: losses, the Noam-warmup Adam over one flat parameter vector,
host-side batch collation and the ``Trainer`` (port of the JAX package's
``train/``)."""

"""The plain reference of NA-MPNN that the benchmark holds the program to.

Plain PyTorch on the reference's own state-dict layout (``nn.Linear``
weights ``[out, in]``), written from the architecture's equations
(ProteinMPNN's message passing with NA-MPNN's 18-slot atom frame): no
kernel, no cache, no batching beyond the rows asked for. It imports
nothing of the program (``na_mpnn_tpu_torch``) and nothing of JAX; it reads
the structures from the files the benchmark wrote and works every feature
out again.
"""

"""Evaluation of the port: ``batch_design`` (many structures through one
device pass), ``harness`` (the design, specificity and RNA-monomer
pipelines and their scoring) with ``scoring``, ``superimpose``,
``external`` and ``ribonanza_runner``, and the set and plot tools
``prepare_sets`` and ``visualize``."""

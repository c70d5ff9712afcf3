"""Evaluation entry points of the port (``batch_design``: many structures
through one device pass)."""

"""A small mix of the LigandMPNN cell, for runs on the CPU."""
LIGAND = {"length": {"dist": "lognormal", "median": 60, "sigma": 0.3, "lo": 40, "hi": 100},
          "ligand_atoms": [15, 30], "dna_bp": [3, 5], "batch_tokens": 200, "batches": 3,
          "profile_seconds": 0.5}

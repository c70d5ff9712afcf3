"""A fault of the LigandMPNN cell, and ``calibrate.py`` with it:

    python3 -m port_bench.faults_context --workload ligand.train --seeds 1,2 \\
        --seconds 10 --fault atom_graph

``atom_graph``: the context encoder drops the atom graph (each
``DecLayerJ`` returns the atoms' states unchanged), ligand.train. It joins
``faults.FAULTS`` when this module is imported, so the harness's other
faults (``half``, ``frozen``) stay at hand.
"""
from __future__ import annotations

import sys

from . import calibrate, faults


def atom_graph(driver):
    from na_mpnn_tpu_torch.models import ligand
    original = ligand.context_layer

    def context_layer(p, h_V, h_E, mask_V, mask_attend, drop=None):
        if h_V.dim() == 4:          # the atom graph: [B, L, M, H]
            return h_V
        return original(p, h_V, h_E, mask_V, mask_attend, drop)
    ligand.context_layer = context_layer


faults.FAULTS.update(atom_graph=atom_graph)

if __name__ == "__main__":
    sys.exit(calibrate.main())

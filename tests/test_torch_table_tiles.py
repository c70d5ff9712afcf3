"""What the message-table forward kernel (``csrc/message_table.cu``) takes
from its wrapper (``ops/message_kernels.py::message_table_cuda``), held on
the CPU, where the kernel itself does not run:

- the tile map ``table_tile_nodes(K)``: tiles of whole nodes, at most 64
  edge rows and 16 nodes each, for any K in 1..64, not only those that
  divide 64, with the wrapper's constants equal to the kernel's;
- ``aligned_weights``: the four weights as the kernel copies them, as
  16-byte vectors, whatever the offset of their views in the flat
  parameter vector, with their values unchanged (compared exactly)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from na_mpnn_tpu_torch.ops import message_kernels as mk

SOURCE = Path(mk.__file__).resolve().parent.parent / "csrc" / "message_table.cu"


def test_tile_nodes_fill_the_tile_with_whole_nodes():
    for K in range(1, mk.MAX_K + 1):
        tn = mk.table_tile_nodes(K)
        assert 1 <= tn <= mk.MAX_TILE_NODES and tn * K <= mk.TILE_ROWS
        assert tn == mk.MAX_TILE_NODES or (tn + 1) * K > mk.TILE_ROWS


def test_tile_constants_are_the_kernels():
    """The kernel refuses a tile map outside its own constants (K up to
    kTileRows, tn up to kMaxTileNodes, tn * K up to kTileRows)."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTileRows") == mk.TILE_ROWS == mk.MAX_K
    assert const("kMaxTileNodes") == mk.MAX_TILE_NODES


@pytest.mark.parametrize("H", [32, 128])
@pytest.mark.parametrize("offset", [0, 1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aligned_weights(dtype, offset, H):
    """Four [H, H] views one after another from ``offset`` elements into a
    flat vector: left as they are when each starts 16-byte aligned, else
    copied once, all aligned, with the same values."""
    rng = np.random.RandomState(offset + H)
    flat = torch.from_numpy(rng.randn(4 * H * H + 16)).to(dtype)
    assert flat.data_ptr() % 16 == 0
    views = tuple(flat[offset + i * H * H:offset + (i + 1) * H * H].view(H, H)
                  for i in range(4))
    got = mk.aligned_weights(*views)
    assert all(w.data_ptr() % 16 == 0 for w in got)
    for w, v in zip(got, views):
        assert w.shape == (H, H) and w.dtype == dtype
        assert torch.equal(w, v)
    aligned = offset * flat.element_size() % 16 == 0
    assert all((w.data_ptr() == v.data_ptr()) == aligned for w, v in zip(got, views))

"""Kernel 13's tile order (`kernels/tile_raster.tile_order`), the order in
which its persistent kernels take the tiles, on the CPU (its plain
version): the tiles by decreasing work, ties in tile order, against a
plain sort in Python. The forward's work is each tile's pair count (from
`bounds`), the backward's each tile's largest `last`. The CUDA sort is
held against this on the card (tests/test_torch_cuda.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mudg_tpu_torch.kernels import tile_raster as KT


def _plain_order(work):
    return sorted(range(len(work)), key=lambda t: (-work[t], t))


@pytest.mark.parametrize("n_tiles,high,seed", [(1, 5, 0), (7, 3, 1), (2400, 4000, 2),
                                               (600, 1, 3), (20000, 300, 4)])
def test_tile_order_from_bounds(n_tiles, high, seed):
    """From the pair counts of seeded `bounds` (heavy-tailed, with ties and
    empty tiles): int32 indices, heaviest first, ties in tile order."""
    rng = np.random.default_rng(seed)
    counts = (rng.random(n_tiles) ** 4 * high).astype(np.int64)
    bounds = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])).int()
    order = KT.tile_order(bounds[1:] - bounds[:-1])
    assert order.dtype == torch.int32
    assert order.tolist() == _plain_order(counts.tolist())


def test_tile_order_from_last():
    """From each tile's largest `last` (n_tiles, 256) i32, as the backward's
    wrapper takes it."""
    rng = np.random.default_rng(5)
    last = torch.from_numpy(rng.integers(0, 50, size=(96, 256)).astype(np.int32))
    last[::5] = 0
    tmax = last.amax(1)
    assert tmax.dtype == torch.int32
    assert KT.tile_order(tmax).tolist() == _plain_order(tmax.tolist())

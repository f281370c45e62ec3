"""GroundTruthDispatcher: the naive dispatch oracle.

The counterpart of the JAX package's ``testing/gt_dispatcher.py``: the
dispatch permutation recomputed from the partition with plain indexing, the
oracle the index arithmetic of ``parallel/dispatch.py`` is held against.
Works on numpy arrays and tensors alike (rows on the first axis)."""

from __future__ import annotations

import numpy as np
import torch

from ..meta.dispatch_meta import DispatchMeta


def _cat(pieces, like):
    if isinstance(like, torch.Tensor):
        return torch.cat(pieces, dim=0)
    return np.concatenate(pieces, axis=0)


class GroundTruthDispatcher:
    def __init__(self, meta: DispatchMeta):
        self.meta = meta

    def dispatch(self, x):
        """Rank-major concatenation of each rank's chunks."""
        cs = self.meta.chunk_size
        return _cat([x[c * cs:(c + 1) * cs] for rank in range(self.meta.cp_size)
                     for c in self.meta.partitions[rank]], x)

    def undispatch(self, y):
        cs = self.meta.chunk_size
        out = y.clone() if isinstance(y, torch.Tensor) else np.empty_like(y)
        pos = 0
        for rank in range(self.meta.cp_size):
            for c in self.meta.partitions[rank]:
                out[c * cs:(c + 1) * cs] = y[pos:pos + cs]
                pos += cs
        return out

    def shard(self, x, rank: int):
        cs = self.meta.chunk_size
        return _cat([x[c * cs:(c + 1) * cs] for c in self.meta.partitions[rank]], x)

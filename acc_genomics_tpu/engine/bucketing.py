"""Length bucketing and batch shaping.

The device replacement for the reference's dispatch layer: length sorting,
segmentation into device-shaped tiles, and trip-count load balancing
(pairhmm/xlnx/host/FalconPairHMM.cpp sortReads/distributeReads and
pairhmm/interface/PairHMMFpgaInterface.cpp dist_reads_to_pu).

On the device there are no PUs to balance; instead the job is to pick
padded (rows, cols) bucket shapes that minimise wasted cells while
keeping the number of distinct compiled shapes small, then pad each
bucket's batch to whole lane blocks.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple


def _round_up(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    raise ValueError(f"length {x} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class BucketPlan:
    """Assignment of pair indices to (rows, cols) bucket shapes."""

    # (rows, cols) -> list of original pair indices
    groups: Dict[Tuple[int, int], List[int]]
    n_pairs: int

    @property
    def shapes(self):
        return sorted(self.groups)

    def padded_cells(self, lane_pad: int = 128) -> int:
        total = 0
        for (r, c), idxs in self.groups.items():
            blocks = -(-len(idxs) // lane_pad)
            total += blocks * lane_pad * r * c
        return total


def plan_buckets(
    read_lens: Sequence[int],
    hap_lens: Sequence[int],
    read_buckets: Sequence[int],
    hap_buckets: Sequence[int],
) -> BucketPlan:
    """Group pairs by padded shape.

    read bucket must exceed the read length (>= 1 absorbing row), so a
    read of length L needs a bucket with rows > L.
    """
    groups: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for k, (rl, hl) in enumerate(zip(read_lens, hap_lens)):
        rows = _round_up(rl + 1, read_buckets)
        cols = _round_up(hl, hap_buckets)
        groups[(rows, cols)].append(k)
    return BucketPlan(dict(groups), len(read_lens))


def trip_count(rows: int, cols: int) -> int:
    """Analytical per-block cost of one kernel block: the diagonal
    count times the wavefront height (the device analog of the
    reference's trip_count formula used for PU balancing,
    PairHMMFpgaInterface.cpp:97)."""
    return (rows + cols) * rows

"""Device mesh construction.

The communication architecture replacing the reference's Blaze
client/daemon offload + per-bank data replication (SURVEY.md §2.6):

* axis "data": batches of (read, hap) pairs are sharded — the analog of
  the reference's DRAM-bank / multi-die data parallelism and of the
  Blaze worker tiling.
* axis "seq": haplotype/target columns are sharded — the analog of the
  reference's segmentation of oversized haps (PairHMMFpga.cpp:284-332),
  turned into true sequence parallelism with collectives.

Read-only reference data (FM-index, pac) is replicated per device, as
the reference replicates the BWT per DRAM bank (smem/host/ocl.cpp).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Tuple[int, int] = (1, 1),
    axis_names: Tuple[str, str] = ("data", "seq"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = shape[0] * shape[1]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)

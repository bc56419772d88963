"""HTC Smith-Waterman engine: bucket -> device fill + walk -> decode.

Replaces the reference dispatch gate FalconSWFPGA_run
(htc-sw/host/FalconSW_FPGA.cpp:16-94): sequences beyond the largest
bucket run on the native host engine (the reference routes len >= 512 to
AVX); everything else runs the batched XLA fill and the device backtrack
walker (ops/sw/walker.py), so the btrack matrix never leaves the device:
only the CIGAR element buffers do, in one transfer per call.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu import native
from acc_genomics_tpu.config import SWConfig
from acc_genomics_tpu.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu.ops.sw.walker import (
    sw_align_batch_decode,
    sw_align_batch_launch,
)


class SWEngine:
    def __init__(
        self,
        config: SWConfig = SWConfig(),
        device: Optional[jax.Device] = None,
        mesh=None,
    ):
        self.config = config
        self.device = device or jax.devices()[0]
        self.mesh = mesh
        self.params = config.params()
        # walk_overflow: in-bucket pairs whose CIGAR overflowed the device
        # walker's element buffer and were rerun on the host
        self.stats = {"pairs": 0, "host_fallback": 0, "walk_overflow": 0,
                      "cells": 0, "device_calls": 0, "d2h_bytes": 0}

    def _bucket(self, n: int) -> Optional[int]:
        for b in self.config.seq_buckets:
            if n <= b:
                return b
        return None

    def align(
        self,
        refs: Sequence[np.ndarray],
        alts: Sequence[np.ndarray],
        strategy: int,
    ) -> List[Tuple[list, int]]:
        """Batch alignment -> [(cigar, offset)] in input order."""
        n = len(refs)
        self.stats["pairs"] += n
        out: List = [None] * n
        groups = {}
        host_idx = []
        for k, (r, a) in enumerate(zip(refs, alts)):
            br = self._bucket(len(r))
            ba = self._bucket(len(a))
            if br is None or ba is None:
                # beyond device buckets: host fallback (AVX-fallback analog)
                host_idx.append(k)
                continue
            groups.setdefault((br, ba), []).append(k)
        host_thread = None
        host_err = []
        if host_idx:
            # run the native host engine on a worker thread CONCURRENTLY
            # with the device bucket launches below — the hybrid CPU/device
            # split of the reference worker (PairHMMWorker.cpp:201-270);
            # the ctypes call releases the GIL, so overlap is real
            self.stats["host_fallback"] += len(host_idx)

            def host_work():
                walked = native.sw_align_host(
                    [refs[k] for k in host_idx], [alts[k] for k in host_idx],
                    strategy, self.params,
                    max_elems=max(self.config.max_seq_len, 1536),
                )
                for j, k in enumerate(host_idx):
                    res = walked[j]
                    if res is None:  # element overflow
                        res = sw_align_oracle(
                            refs[k], alts[k], strategy, params=self.params
                        )
                    out[k] = res

            def host_work_guarded():
                try:
                    host_work()
                except BaseException as e:  # re-raised after join
                    host_err.append(e)

            host_thread = threading.Thread(target=host_work_guarded)
            host_thread.start()

        # segment each bucket group into device launches of at most
        # max_batch pairs (the reference's 260-alt batch cap, resized for
        # a wide device; htc-sw/host/common.h:14); launch every chunk's
        # fill + walk, then fetch all element buffers as ONE transfer
        seg = max(int(self.config.max_batch), 1)
        pend = []
        for (rows, cols), idxs in groups.items():
            for lo in range(0, len(idxs), seg):
                chunk = idxs[lo : lo + seg]
                grefs = [refs[k] for k in chunk]
                galts = [alts[k] for k in chunk]
                packed = sw_align_batch_launch(
                    grefs, galts, strategy, rows, cols, mesh=self.mesh,
                    params=self.params, device=self.device,
                )
                self.stats["device_calls"] += 1
                pend.append((chunk, grefs, galts, packed))
        if pend:
            allpacked = np.asarray(
                jnp.concatenate([p[3] for p in pend], axis=1)
            )
            self.stats["d2h_bytes"] += allpacked.nbytes
            col = 0
            for chunk, grefs, galts, packed in pend:
                w = packed.shape[1]
                walked = sw_align_batch_decode(
                    allpacked[:, col : col + w], grefs, galts, strategy,
                    params=self.params, stats=self.stats,
                )
                col += w
                for k, res in zip(chunk, walked):
                    self.stats["cells"] += len(refs[k]) * len(alts[k])
                    out[k] = res
        if host_thread is not None:
            host_thread.join()
            if host_err:
                raise host_err[0]
        return out

    def align_one_ref(self, ref: np.ndarray, alts: Sequence[np.ndarray], strategy: int):
        """SWPairwiseAlignmentMultiBatch analog: one ref vs many alts."""
        return self.align([ref] * len(alts), alts, strategy)

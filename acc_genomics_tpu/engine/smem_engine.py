"""SMEM engine: device-resident FM-index + batched collection.

The index is uploaded once and kept in HBM across calls — the device analog
of the reference writing the (replicated) BWT to every DRAM bank at init
(smem/host/ocl.cpp:169-293) and of BWAOCLEnv's one-time pac preload.
Reads whose interval count exceeds MAX_INTV_ALLOC are rerun on the host
oracle, matching the reference's overflow contract (smem/main.cpp:158-164).

The device path is the flat state machine of ops/smem/machine.py (one
batched 32-byte FM-index probe per iteration for every lane).  Workloads
wider than one device batch run the MULTI-READ machine: each lane
processes Q reads sequentially (in-body switching), so the while-loop
iteration count tracks the max over lanes of the SUM of Q per-read step
counts — sums concentrate (CLT), killing the 54% DONE-wait the one-shot
batch pays to its slowest lane.  This is the device analog of the
reference streaming reads through resident PEs
(smem/device/smem.cpp MAX_TILE_SIZE in-flight reads per stage).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import numpy as np

from acc_genomics_tpu.config import SmemConfig
from acc_genomics_tpu.ops.smem.index import FMIndex
from acc_genomics_tpu.ops.smem.machine import (
    _collect_jit,
    _collect_multi_jit,
    device_index_fused,
    intervals_to_dicts,
    smem_batch_machine,
)
from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu.utils.timer import Timer


class SmemEngine:
    def __init__(
        self,
        fm: FMIndex,
        config: SmemConfig = SmemConfig(),
        device: Optional[jax.Device] = None,
        mesh=None,
    ):
        self.fm = fm
        self.config = config
        self.device = device or jax.devices()[0]
        self.mesh = mesh
        with Timer("smem.index_upload"):
            idx = device_index_fused(fm)
            if mesh is not None:
                # replicate the index on every mesh device (the analog of
                # the reference replicating the BWT per DRAM bank)
                from jax.sharding import NamedSharding, PartitionSpec as P

                rep = NamedSharding(mesh, P())
                self.idx = {k: jax.device_put(v, rep) for k, v in idx.items()}
            else:
                self.idx = {
                    k: (jax.device_put(v, self.device) if hasattr(v, "shape") else v)
                    for k, v in idx.items()
                }
        self.params = config.params()
        self.stats = {"reads": 0, "overflow_reruns": 0, "probe_iters": 0}
        # per-phase anatomy counters (the event-profiling discipline of
        # smem/host/ocl.cpp:339-344): pack (host CPU), launch (H2D upload
        # + async dispatch), wait (first small fetch = machine compute on
        # the device), fetch (bulk D2H of results).  bench.py emits these
        # as extras so every e2e number reconciles against its phases.
        self.anatomy = dict(
            pack_s=0.0, launch_s=0.0, wait_s=0.0, fetch_s=0.0,
            h2d_bytes=0, d2h_bytes=0,
        )

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0.0 if k.endswith("_s") else 0

    def collect(self, reads: List[np.ndarray]) -> List[List[dict]]:
        """3-pass SMEM intervals per read."""
        self.stats["reads"] += len(reads)
        seq_len = self.config.seq_length
        buckets = tuple(
            b for b in getattr(self.config, "read_buckets", (seq_len,))
            if b <= seq_len
        ) or (seq_len,)
        out: List = [None] * len(reads)
        # route oversized reads straight to host; bucket the rest by
        # length (the machine's interval buffers are (bucket+1, B), so a
        # tight bucket halves the masked-buffer work for short reads)
        host_idx = [k for k, r in enumerate(reads) if len(r) > seq_len]
        groups = {}
        for k, r in enumerate(reads):
            if len(r) > seq_len:
                continue
            b = next(b for b in buckets if len(r) <= b)
            groups.setdefault(b, []).append(k)
        # host reruns run on a single worker thread CONCURRENTLY with the
        # device loop (the hybrid CPU||device split of the reference
        # worker, PairHMMWorker.cpp:201-270): oversized reads are known
        # before launch and dispatch immediately; overflow/bust lanes
        # dispatch as each device batch reports them, overlapping the
        # remaining batches.  The ctypes call releases the GIL.
        def host_work(idx_chunk):
            from acc_genomics_tpu import native

            host_reads = [reads[k] for k in idx_chunk]
            hres = native.smem_collect_host(self.fm, host_reads, self.params)
            for j, k in enumerate(idx_chunk):
                r = hres[j]
                if r is None:  # output overflow of the native engine
                    r = mem_collect_intv_oracle(self.fm, reads[k], self.params)
                out[k] = r

        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        futures = []
        if host_idx:
            with Timer("smem.host_dispatch"):
                futures.append(pool.submit(host_work, list(host_idx)))
        # groups wider than one device batch run the multi-read machine
        # (Q reads per lane); groups bigger than Q_max * batch segment.
        # With a mesh the same path runs through smem_collect_multi_dp
        # (lanes sharded over "data"), provided the lane count divides
        # the data axis — the production path and the distributed path
        # stay the SAME machine (no silent downgrade to one-shot batches
        # under a mesh).
        seg = max(int(self.config.batch_size), 1)
        dsz = int(self.mesh.shape["data"]) if self.mesh is not None else 1
        try:
            for b, idxs in groups.items():
                if len(idxs) > seg and seg % dsz == 0:
                    rerun = self._collect_multi(reads, idxs, b, out)
                    if rerun:
                        futures.append(pool.submit(host_work, rerun))
                    continue
                for lo in range(0, len(idxs), seg):
                    dev_idx = idxs[lo : lo + seg]
                    with Timer("smem.device"):
                        res, overflow, iters = smem_batch_machine(
                            self.idx, [reads[k] for k in dev_idx], seq_len=b,
                            mesh=self.mesh, params=self.params,
                        )
                    self.stats["probe_iters"] += iters
                    rerun = []
                    for j, k in enumerate(dev_idx):
                        if overflow[j]:
                            rerun.append(k)
                            self.stats["overflow_reruns"] += 1
                        else:
                            out[k] = res[j]
                    if rerun:
                        futures.append(pool.submit(host_work, rerun))
            with Timer("smem.host_join"):
                for f in futures:
                    f.result()  # re-raise host errors
        finally:
            pool.shutdown(wait=True)
            # surface host-worker failures even when the device loop
            # raised first (the host error is often the root cause);
            # never mask the primary exception
            import sys

            for f in futures:
                if f.done() and not f.cancelled() and f.exception():
                    print(
                        f"smem host worker failed: {f.exception()!r}",
                        file=sys.stderr,
                    )
        return out

    def _collect_multi(self, reads, idxs, bucket, out):
        """Multi-read collection of reads[idxs] (all <= bucket long)
        through collect_arrays' Q-reads-per-lane path; results land in
        out[k] as interval dicts.  Returns indices needing host rerun."""
        n = len(idxs)
        seq_tm = np.full((bucket, n), 4, np.uint8)
        lens = np.zeros(n, np.int32)
        for j, k in enumerate(idxs):
            r = reads[k]
            seq_tm[: len(r), j] = r
            lens[j] = len(r)
        with Timer("smem.device_multi"):
            memc, mem_n, overflow = self.collect_arrays(
                seq_tm, lens, _count_reads=False
            )
        div = intervals_to_dicts(memc, mem_n, n)
        rerun = []
        for j, k in enumerate(idxs):
            if overflow[j]:
                rerun.append(k)
                self.stats["overflow_reruns"] += 1
            else:
                out[k] = div[j]
        return rerun

    def collect_arrays(self, seq_tm: np.ndarray, lens: np.ndarray,
                       _count_reads: bool = True):
        """Raw-array SMEM collection for device pipelines (no per-interval
        dict conversion): seq_tm (L, B) uint8 codes, lens (B,).

        Returns (mem (5, used, B) int32 [x0,x1,s,start,end], mem_n (B,),
        overflow (B,) bool).  Overflow/bust lanes carry no intervals here;
        callers route those reads through the host path.

        Batches wider than config.batch_size run the MULTI-READ machine:
        Q = ceil(B / batch_size) reads per lane (capped at
        config.max_reads_per_lane; wider workloads segment).  Read
        q*batch + b is lane b's q-th read; outputs are re-densified to
        the per-read layout here.
        """
        import jax.numpy as jnp

        B = seq_tm.shape[1]
        if _count_reads:
            self.stats["reads"] += B
        seg = max(int(self.config.batch_size), 1)
        qmax = max(int(getattr(self.config, "max_reads_per_lane", 8)), 1)
        cap = self.params.max_intv_alloc
        if B > seg:
            # multi-read segments, launch-all-then-drain: every part's
            # machine + densify dispatch asynchronously before any part
            # is fetched, so part k's D2H streams over the link while
            # part k+1 computes (the engine-wide async discipline)
            step = seg * qmax
            with Timer("smem.device_multi"):
                handles = [
                    self._multi_launch(seq_tm[:, lo : lo + step],
                                       lens[lo : lo + step], seg)
                    for lo in range(0, B, step)
                ]
                parts = [self._multi_finish(h) for h in handles]
            if len(parts) == 1:
                return parts[0]
            used = max(p[0].shape[1] for p in parts)

            def padu(m):
                pad = used - m.shape[1]
                if pad:
                    m = np.concatenate(
                        [m, np.zeros((5, pad, m.shape[2]), m.dtype)], axis=1
                    )
                return m

            return (
                np.concatenate([padu(p[0]) for p in parts], axis=2),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
            )

        import time as _t

        from acc_genomics_tpu.ops.smem.machine import smem_flat_gather

        with Timer("smem.device"):
            t0 = _t.perf_counter()
            if self.mesh is not None:
                from acc_genomics_tpu.parallel.sharded_kernels import (
                    smem_collect_dp,
                )

                dsz = int(self.mesh.shape["data"])
                pad = (-B) % dsz
                if pad:  # inert zero-length lanes to fill the data axis
                    seq_tm = np.concatenate(
                        [seq_tm, np.full((seq_tm.shape[0], pad), 4, seq_tm.dtype)],
                        axis=1,
                    )
                    lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
                from acc_genomics_tpu.parallel.sharded import shard_lanes

                mem, mem_n, iters = smem_collect_dp(
                    self.mesh, self.idx,
                    *shard_lanes(self.mesh, (seq_tm, lens)),
                    params=self.params,
                )
                mem = [m[:, :B] for m in mem]
                mem_n = mem_n[:B]
                iters = jnp.max(iters)
            else:
                mem, mem_n, iters = _collect_jit(
                    self.idx, jax.device_put(seq_tm, self.device),
                    jax.device_put(lens, self.device), params=self.params,
                )
            t1 = _t.perf_counter()
            self.anatomy["launch_s"] += t1 - t0
            self.anatomy["h2d_bytes"] += seq_tm.nbytes + lens.nbytes
            mem_n, iters = jax.device_get((mem_n, jnp.asarray(iters)))
            t2 = _t.perf_counter()
            self.anatomy["wait_s"] += t2 - t1
            self.anatomy["d2h_bytes"] += mem_n.nbytes + 8
            self.stats["probe_iters"] += int(iters)
            used = int(min(cap, mem_n.max(initial=0)))
            overflow = mem_n > cap
            nn = (np.minimum(mem_n, cap) * ~overflow).astype(np.int32)
            # ragged fetch (see _multi_finish): the (used, B) rectangle's
            # row count is the per-batch MAX interval count, ~2x the
            # mean — ship exactly the live intervals instead
            tot = int(nn.sum())
            memc = np.zeros((5, used, B), np.int32)
            if tot:
                totp = max(-(-tot // 65536) * 65536, 65536)
                f32, f16 = smem_flat_gather(
                    mem,
                    jnp.zeros(B, jnp.int32),
                    jnp.arange(B, dtype=jnp.int32),
                    jnp.asarray(nn), tot=totp,
                )
                f32, f16 = jax.device_get((f32, f16))
                self.anatomy["d2h_bytes"] += f32.nbytes + f16.nbytes
                flat = np.concatenate([f32, f16.astype(np.int32)])[:, :tot]
                rid_h = np.repeat(np.arange(B), nn)
                jr_h = np.arange(tot) - np.repeat(np.cumsum(nn) - nn, nn)
                memc[:, jr_h, rid_h] = flat
            self.anatomy["fetch_s"] += _t.perf_counter() - t2
        self.stats["overflow_reruns"] += int(overflow.sum())
        return memc, nn, overflow

    def _multi_pack(self, seq_tm, lens, B_lane):
        """Host-side pool pack for the multi-read machine.

        Pool layout: read id q*B + b -> lane b, slot q (pads trail per
        lane since ids are monotone in q for fixed b).  The pool is
        2-bit packed ON HOST (words + N-bitmask planes) — the packed
        upload is ~2.6x fewer bytes than uint8, and the machine's
        per-step seq reads want the packed layout anyway."""
        L, n = seq_tm.shape
        L32 = ((L + 31) // 32) * 32  # machine requires L % 32 == 0
        Q = max(-(-n // B_lane), 1)
        NB = Q * B_lane
        seqp = np.full((L32, NB), 4, np.uint8)
        seqp[:L, :n] = seq_tm
        lensp = np.zeros(NB, np.int32)
        lensp[:n] = lens
        pool = (
            seqp.reshape(L32, Q, B_lane).transpose(1, 0, 2)
            .reshape(Q * L32, B_lane)
        )
        # 2-bit pack: 16 bases/word MSB-first + 1-bit N mask, 32/word.
        # Progressive pairwise combine in uint8 (2 bases/nibble -> 4
        # bases/byte -> 4 bytes/word big-endian): same bits as the old
        # widen-to-uint32 + strided sum, but the temporaries shrink from
        # ~270 MB to ~35 MB and the r05 bench's 6.6 s/rep pack phase
        # drops ~4x on this 1-core host (A/B'd bit-exact)
        p = pool & np.uint8(3)  # base 4 (N/pad) -> 0, as where() did
        p01 = (p[0::2] << np.uint8(2)) | p[1::2]
        p03 = (p01[0::2] << np.uint8(4)) | p01[1::2]
        words = (
            (p03[0::4].astype(np.uint32) << 24)
            | (p03[1::4].astype(np.uint32) << 16)
            | (p03[2::4].astype(np.uint32) << 8)
            | p03[3::4]
        )
        nbit = np.packbits(pool >= 4, axis=0)  # MSB-first byte planes
        nmask = (
            (nbit[0::4].astype(np.uint32) << 24)
            | (nbit[1::4].astype(np.uint32) << 16)
            | (nbit[2::4].astype(np.uint32) << 8)
            | nbit[3::4]
        )
        packed = np.concatenate([words, nmask]).view(np.int32)
        # lane output rows must hold Q reads' intervals: measured lane
        # totals at 101 bp/100 Mbp are ~6.2/read mean, max 51 at Q=8,
        # and rows still cost ~4 us/10 rows/step even with the hot
        # buffer (56 vs 66 rows A/B'd 812 vs 852 us) — keep the cap
        # tight; overshoots bust to host rerun (graceful, exact)
        mp = self.params._replace(
            mem_cap=min(self.params.max_intv_alloc,
                        self.params.mem_cap + 4 * (Q - 1) + 4)
        )
        return packed, lensp.reshape(Q, B_lane), Q, mp

    def _multi_launch(self, seq_tm, lens, B_lane):
        """Pack + upload + async-dispatch one multi-read machine call."""
        import time as _t

        import jax.numpy as jnp

        n = seq_tm.shape[1]
        t0 = _t.perf_counter()
        packed, lens_q, Q, mp = self._multi_pack(seq_tm, lens, B_lane)
        t1 = _t.perf_counter()
        self.anatomy["pack_s"] += t1 - t0
        self.anatomy["h2d_bytes"] += packed.nbytes + lens_q.nbytes
        if self.mesh is not None:
            from acc_genomics_tpu.parallel.sharded import shard_lanes
            from acc_genomics_tpu.parallel.sharded_kernels import (
                smem_collect_multi_dp,
            )

            mem, mem_n, bnd, bq, iters = smem_collect_multi_dp(
                self.mesh, self.idx, *shard_lanes(self.mesh, (packed, lens_q)),
                reads_per_lane=Q, params=mp,
            )
            iters = jnp.max(iters)
        else:
            put = lambda a: jax.device_put(a, self.device)
            mem, mem_n, bnd, bq, iters = _collect_multi_jit(
                self.idx, put(packed), put(lens_q),
                params=mp, reads_per_lane=Q,
            )
        self.anatomy["launch_s"] += _t.perf_counter() - t1
        return dict(mem=mem, mem_n=mem_n, bnd=bnd, bq=bq, iters=iters,
                    n=n, B=B_lane, Q=Q)

    def _multi_finish(self, h):
        """Drain one multi-read call: small boundary fetch, then one
        ragged device-side gather of exactly the live intervals
        (machine.smem_flat_gather)."""
        import time as _t

        import jax.numpy as jnp

        from acc_genomics_tpu.ops.smem.machine import smem_flat_gather

        n, B_lane = h["n"], h["B"]
        t0 = _t.perf_counter()
        bnd, bq, iters = jax.device_get(
            (h["bnd"], h["bq"], jnp.asarray(h["iters"]))
        )
        self.anatomy["wait_s"] += _t.perf_counter() - t0
        self.anatomy["d2h_bytes"] += bnd.nbytes + bq.nbytes + 8
        self.stats["probe_iters"] += int(iters)
        # per-read boundaries: row q = absolute mem_n after read q
        # (cummax fills rows of padded/early-parked lanes)
        bnd = np.maximum.accumulate(bnd.astype(np.int64), axis=0)
        starts = np.vstack([np.zeros((1, B_lane), np.int64), bnd[:-1]])
        counts = np.clip(bnd - starts, 0, None) * ~bq
        sf = starts.reshape(-1)[:n].astype(np.int32)
        cf = counts.reshape(-1)[:n].astype(np.int32)
        used = max(int(cf.max(initial=0)), 1)
        used = ((used + 3) // 4) * 4  # bucket the downstream rectangle
        t1 = _t.perf_counter()
        # ragged fetch: ship exactly the live intervals (flat, read-
        # major) instead of the used*n rectangle — the rectangle's row
        # count is the max per-read count (~2x the mean at Q=8), and
        # this fetch is the multi path's link-bound phase
        tot = int(cf.sum())
        totp = max(-(-(tot) // 262144) * 262144, 262144)
        f32, f16 = smem_flat_gather(
            h["mem"], jnp.asarray(sf),
            jnp.asarray((np.arange(n) % B_lane).astype(np.int32)),
            jnp.asarray(cf), tot=totp,
        )
        f32, f16 = jax.device_get((f32, f16))
        self.anatomy["fetch_s"] += _t.perf_counter() - t1
        self.anatomy["d2h_bytes"] += f32.nbytes + f16.nbytes
        flat = np.concatenate([f32, f16.astype(np.int32)])[:, :tot]
        memc = np.zeros((5, used, n), np.int32)  # host RAM is not the link
        if tot:
            rid_h = np.repeat(np.arange(n), cf)
            jr_h = np.arange(tot) - np.repeat(np.cumsum(cf) - cf, cf)
            memc[:, jr_h, rid_h] = flat
        ovf = np.asarray(bq).reshape(-1)[:n]
        self.stats["overflow_reruns"] += int(ovf.sum())
        return memc, cf * ~ovf, ovf

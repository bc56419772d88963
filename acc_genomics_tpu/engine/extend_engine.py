"""Seed-extension engine: batched left/right extension with resolution.

The accelerator analog of the reference's seed pipeline (bwa-sw/sdaccel/
smithwaterman.cpp read_proc/seed_proc): seeds are flattened into a batch,
all LEFT extensions run as one device call, then all RIGHT extensions
(whose h0 is the left result) as a second call — the dependent 2-step
loop of seed_proc becomes two dense batches instead of 20 seed PEs.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.config import ExtendConfig
from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch
from acc_genomics_tpu.utils.timer import Timer


_KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off", "w")


def _pack_tm(seqs, L: int, bsz: int):
    """Pad-pack a list of 1-D code arrays into a time-major (L, bsz)
    uint8 buffer (pad 4) with ONE contiguous fancy scatter; returns
    (buf, lens (len(seqs),) int32).

    Replaces the per-task Python fill loop, which at 4096 seeds/batch
    was the engine's dominant cost (~35 us/seed of pure Python).  The
    scatter
    targets the READ-major flat layout (writes per seq are consecutive
    addresses — a strided time-major scatter measured 2x slower) with
    flat indices built by one cumsum instead of two large np.repeats
    (7-10 ms -> ~1 ms at 4096 x 200); one transpose copy at the end
    restores time-major.  Negative-stride views (reversed queries)
    concatenate fine — the concat is the only other host copy."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    tot = int(lens.sum())
    flat = np.full(bsz * L, 4, np.uint8)
    if tot:
        cat = np.concatenate(seqs).astype(np.uint8, copy=False)
        # flat index of seq j element i is j*L + i: within a seq the
        # step is 1, at each seq boundary it jumps — build by cumsum
        # (zero-length seqs contribute no boundary, so jumps span them)
        jarr = np.flatnonzero(lens)
        lnz = lens[jarr]
        d = np.ones(tot, np.int64)
        d[0] = jarr[0] * L
        if len(jarr) > 1:
            d[np.cumsum(lnz[:-1])] = (
                (jarr[1:] - jarr[:-1]) * L - lnz[:-1] + 1
            )
        flat[np.cumsum(d)] = cat
    return (
        np.ascontiguousarray(flat.reshape(bsz, L).T),
        lens.astype(np.int32),
    )


def _bucket_ladder(start: int, cap: int):
    """Power-of-two ladder from start up to (and including) cap."""
    out = []
    b = start
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(out)


import functools


@functools.lru_cache(maxsize=64)
def _fused_device_fn(meta_sig, params):
    """ONE jitted program for a whole fused extend batch: slice every
    group's planes out of the flat uint8/int32 uploads, run all left
    extensions, resolve the left->right h0 dependency with a take over
    the concatenated left scores, run all right extensions, and return
    one (7, total-cols) result — a single dispatch instead of ~4 per
    group.  Memoized on the group-shape signature (d, bsz, bq, bt per
    group), which the bucket ladders quantize to a handful of variants."""
    import jax
    import jax.numpy as jnp

    def run(du8, di32):
        def dispatch(q, t, qlen, tlen, h0):
            res = sw_extend_batch(q, t, qlen, tlen, h0, qlen, qlen,
                                  params=params)
            return jnp.stack([res[k] for k in _KEYS])

        o8 = o32 = 0
        lpk, rpend = [], []
        for d, bsz, bq, bt in meta_sig:
            q = jax.lax.slice(du8, (o8,), (o8 + bq * bsz,)).reshape(bq, bsz)
            o8 += bq * bsz
            t = jax.lax.slice(du8, (o8,), (o8 + bt * bsz,)).reshape(bt, bsz)
            o8 += bt * bsz
            qlen = jax.lax.slice(di32, (o32,), (o32 + bsz,))
            tlen = jax.lax.slice(di32, (o32 + bsz,), (o32 + 2 * bsz,))
            side = jax.lax.slice(di32, (o32 + 2 * bsz,), (o32 + 3 * bsz,))
            o32 += 3 * bsz
            if d == 0:
                lpk.append(dispatch(q, t, qlen, tlen, side))
            else:
                rpend.append((q, t, qlen, tlen, side))
        Lpk = jnp.concatenate(lpk, axis=1)
        rpk = [
            dispatch(q, t, qlen, tlen, jnp.take(Lpk[0], side))
            for q, t, qlen, tlen, side in rpend
        ]
        return jnp.concatenate([Lpk] + rpk, axis=1)

    return jax.jit(run)


class ExtendEngine:
    def __init__(
        self,
        config: ExtendConfig = ExtendConfig(),
        device: Optional[jax.Device] = None,
        mesh=None,
    ):
        self.config = config
        self.device = device or jax.devices()[0]
        self.mesh = mesh
        self._data_size = int(mesh.shape["data"]) if mesh is not None else 1
        # device bucket ladders bounded by the configured caps; tasks past
        # the caps fall back to the host oracle (FalconSW_FPGA.cpp:43-51
        # gate pattern) instead of raising
        self.q_buckets = _bucket_ladder(32, config.max_qlen)
        self.t_buckets = _bucket_ladder(64, config.max_tlen)
        self.params = config.params()
        self.stats = {"seeds": 0, "device_calls": 0, "host_fallback": 0}
        # per-phase anatomy (see SmemEngine.anatomy): prep = per-seed
        # task construction, pack = pad-buffer fill, launch = H2D +
        # dispatch, fetch = the one batched D2H
        self.anatomy = dict(
            prep_s=0.0, pack_s=0.0, launch_s=0.0, fetch_s=0.0,
            h2d_bytes=0, d2h_bytes=0,
        )

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0.0 if k.endswith("_s") else 0

    def _bucket_of(self, q, t):
        """(bq, bt) device bucket for one task, or None -> host fallback."""
        ql = max(len(q), 1)
        tl = max(len(t), 1)
        if ql > self.q_buckets[-1] or tl > self.t_buckets[-1]:
            return None
        bq = next(b for b in self.q_buckets if ql <= b)
        bt = next(b for b in self.t_buckets if tl <= b)
        return bq, bt

    def _pack_group(self, queries, targets, idxs, bq, bt):
        """Pad-pack one (bq, bt) bucket group into device-shaped host
        buffers; returns (idxs, bsz, q_tm, t_tm, qlen, tlen)."""
        bsz = max(8, self._data_size)
        while bsz < len(idxs):  # x4 ladder: very few cached shapes
            bsz *= 4
        if bsz % self._data_size:
            bsz += self._data_size - bsz % self._data_size
        m = len(idxs)
        q_tm, ql_m = _pack_tm([queries[k] for k in idxs], bq, bsz)
        t_tm, tl_m = _pack_tm([targets[k] for k in idxs], bt, bsz)
        qlen = np.zeros(bsz, np.int32)
        tlen = np.zeros(bsz, np.int32)
        qlen[:m] = ql_m
        tlen[:m] = tl_m
        return idxs, bsz, q_tm, t_tm, qlen, tlen

    def _run_fused(self, lq, lt, h0l, rq, rt):
        """Both directions in ONE device round trip: every group's planes
        ship as one uint8 + one int32 H2D, the left->right h0 dependency
        resolves ON DEVICE (a take over the concatenated left scores),
        and all results come back in one batched D2H.  The reference
        hides the same host/device latency with its double-buffered
        worker (bwa-sw/intel/aocl/src/main_cl.cpp:54-180)."""
        import jax.numpy as jnp

        n = len(lq)
        out_l = {k: np.zeros(n, np.int64) for k in _KEYS}
        out_r = {k: np.zeros(n, np.int64) for k in _KEYS}
        groups_l, groups_r, host_idx = {}, {}, []
        for k in range(n):
            bl = self._bucket_of(lq[k], lt[k])
            br = self._bucket_of(rq[k], rt[k])
            if bl is None or br is None:
                host_idx.append(k)  # host runs BOTH directions
                continue
            groups_l.setdefault(bl, []).append(k)
            groups_r.setdefault(br, []).append(k)

        # host fallback on a worker thread, concurrent with device work
        host_thread = None
        host_err = []
        if host_idx:
            import threading

            from acc_genomics_tpu import native

            self.stats["host_fallback"] += len(host_idx)

            def host_work():
                lqs = [lq[k] for k in host_idx]
                lts = [lt[k] for k in host_idx]
                h0s = [int(h0l[k]) for k in host_idx]
                hl = native.sw_extend_host(lqs, lts, h0s, self.params)
                h0r = [int(v) for v in hl["score"]]
                rqs = [rq[k] for k in host_idx]
                rts = [rt[k] for k in host_idx]
                hr = native.sw_extend_host(rqs, rts, h0r, self.params)
                for j, k in enumerate(host_idx):
                    for key in _KEYS:
                        out_l[key][k] = hl[key][j]
                        out_r[key][k] = hr[key][j]

            def host_work_guarded():
                try:
                    host_work()
                except BaseException as e:
                    host_err.append(e)

            host_thread = threading.Thread(target=host_work_guarded)
            host_thread.start()

        with Timer("extend.device"):
            # ---- pack every group of both directions (host CPU) --------
            t0p = _time.perf_counter()
            metas = []  # (dir, idxs, bsz, bq, bt)
            u8_parts, i32_parts = [], []
            posL = np.zeros(n, np.int64)  # task k -> column in concat left out
            colL = 0
            for d, groups, qs, ts in (
                (0, groups_l, lq, lt), (1, groups_r, rq, rt)
            ):
                for (bq, bt), idxs in groups.items():
                    idxs, bsz, q_tm, t_tm, qlen, tlen = self._pack_group(
                        qs, ts, idxs, bq, bt
                    )
                    m = len(idxs)
                    u8_parts += [q_tm.ravel(), t_tm.ravel()]
                    side = np.zeros(bsz, np.int32)
                    if d == 0:
                        side[:m] = np.fromiter(
                            (h0l[k] for k in idxs), np.int64, m
                        )
                        posL[idxs] = colL + np.arange(m)
                        colL += bsz
                    else:
                        side[:m] = posL[idxs]  # take-index into left scores
                    i32_parts += [qlen, tlen, side]
                    metas.append((d, idxs, bsz, bq, bt))
                    self.stats["device_calls"] += 1
            self.anatomy["pack_s"] += _time.perf_counter() - t0p

            if metas:
                # ---- ONE uint8 + ONE int32 upload, ONE jitted dispatch --
                t0l = _time.perf_counter()
                du8 = jax.device_put(np.concatenate(u8_parts), self.device)
                di32 = jax.device_put(np.concatenate(i32_parts), self.device)
                self.anatomy["h2d_bytes"] += du8.size + 4 * di32.size
                sig = tuple((d, bsz, bq, bt) for d, _, bsz, bq, bt in metas)
                out_dev = _fused_device_fn(sig, self.params)(du8, di32)
                self.anatomy["launch_s"] += _time.perf_counter() - t0l

                # ---- ONE batched D2H for both directions ----------------
                t0f = _time.perf_counter()
                allpk = np.asarray(out_dev)
                self.anatomy["fetch_s"] += _time.perf_counter() - t0f
                self.anatomy["d2h_bytes"] += allpk.nbytes

                col = 0
                for d, idxs, bsz, bq, bt in metas:
                    block = allpk[:, col : col + bsz]
                    col += bsz
                    tgt = out_l if d == 0 else out_r
                    ia = np.asarray(idxs, np.int64)
                    for r, key in enumerate(_KEYS):
                        tgt[key][ia] = block[r, : len(idxs)]

            if host_thread is not None:
                host_thread.join()
                if host_err:
                    raise host_err[0]
        return out_l, out_r

    def _run(self, queries, targets, h0s) -> Dict[str, np.ndarray]:
        """One direction for a set of tasks, bucketed by padded shape.
        Oversize tasks (query/target beyond the configured caps) run on
        the host oracle concurrently with the device groups."""
        n = len(queries)
        out = {k: np.zeros(n, np.int64) for k in
               ("score", "qle", "tle", "gtle", "gscore", "max_off", "w")}
        groups = {}
        host_idx = []
        for k in range(n):
            ql = max(len(queries[k]), 1)
            tl = max(len(targets[k]), 1)
            if ql > self.q_buckets[-1] or tl > self.t_buckets[-1]:
                host_idx.append(k)
                continue
            bq = next(b for b in self.q_buckets if ql <= b)
            bt = next(b for b in self.t_buckets if tl <= b)
            groups.setdefault((bq, bt), []).append(k)
        # launch every group before fetching any result: device compute
        # overlaps host packing, and all D2H transfers batch into one
        # device_get (one round trip instead of one per (group, field))
        pending = []
        with Timer("extend.device"):
            for (bq, bt), idxs in groups.items():
                bsz = max(8, self._data_size)
                while bsz < len(idxs):  # x4 ladder: very few cached shapes
                    bsz *= 4
                if bsz % self._data_size:
                    bsz += self._data_size - bsz % self._data_size
                # uint8 on the wire (codes <= 4); device-side casts are free
                t0p = _time.perf_counter()
                m = len(idxs)
                q_tm, ql_m = _pack_tm([queries[k] for k in idxs], bq, bsz)
                t_tm, tl_m = _pack_tm([targets[k] for k in idxs], bt, bsz)
                qlen = np.zeros(bsz, np.int32)
                tlen = np.zeros(bsz, np.int32)
                h0 = np.zeros(bsz, np.int32)
                qlen[:m] = ql_m
                tlen[:m] = tl_m
                h0[:m] = np.fromiter((h0s[k] for k in idxs), np.int64, m)
                self.anatomy["pack_s"] += _time.perf_counter() - t0p
                self.anatomy["h2d_bytes"] += (
                    q_tm.nbytes + t_tm.nbytes + 3 * qlen.nbytes
                )
                self.stats["device_calls"] += 1
                t0l = _time.perf_counter()
                host_args = (q_tm, t_tm, qlen, tlen, h0, qlen, qlen)
                if self.mesh is not None:
                    from acc_genomics_tpu.parallel.sharded import shard_lanes
                    from acc_genomics_tpu.parallel.sharded_kernels import (
                        sw_extend_dp,
                    )

                    res = sw_extend_dp(
                        self.mesh, *shard_lanes(self.mesh, host_args),
                        params=self.params,
                    )
                else:
                    res = sw_extend_batch(
                        *[jax.device_put(a, self.device) for a in host_args],
                        params=self.params,
                    )
                packed = jnp.stack([res[k] for k in _KEYS])
                pending.append((idxs, packed))
                self.anatomy["launch_s"] += _time.perf_counter() - t0l
            # host fallback for oversize tasks on a worker thread, running
            # CONCURRENTLY with device compute + the D2H fetch below (the
            # hybrid CPU/device split of PairHMMWorker.cpp:201-270; the
            # native ksw_extend2 call releases the GIL)
            host_thread = None
            host_err = []
            if host_idx:
                from acc_genomics_tpu import native

                self.stats["host_fallback"] += len(host_idx)

                def host_work():
                    hres = native.sw_extend_host(
                        [queries[k] for k in host_idx],
                        [targets[k] for k in host_idx],
                        [int(h0s[k]) for k in host_idx],
                        self.params,
                    )
                    for j, k in enumerate(host_idx):
                        for key in _KEYS:
                            out[key][k] = hres[key][j]

                import threading

                def host_work_guarded():
                    try:
                        host_work()
                    except BaseException as e:  # re-raised after join
                        host_err.append(e)

                host_thread = threading.Thread(target=host_work_guarded)
                host_thread.start()
            # ONE D2H transfer for every group: all (7, bsz_g) group
            # results concatenate on device first
            if pending:
                t0f = _time.perf_counter()
                allpacked = np.asarray(
                    jnp.concatenate([p for _, p in pending], axis=1)
                )
                self.anatomy["fetch_s"] += _time.perf_counter() - t0f
                self.anatomy["d2h_bytes"] += allpacked.nbytes
            if host_thread is not None:
                host_thread.join()
                if host_err:
                    raise host_err[0]
        col = 0
        for idxs, packed in pending:
            ia = np.asarray(idxs, np.int64)
            w = packed.shape[1]
            for r, key in enumerate(_KEYS):
                out[key][ia] = allpacked[r, col : col + len(idxs)]
            col += w
        return out

    def extend_seeds(self, seeds: Sequence[dict]) -> List[dict]:
        """Each seed: read, rseq, qbeg, rbeg_off, len -> resolved alignment
        record (qBeg/qEnd/rBeg/rEnd/score/trueScore/width), seed_proc
        semantics."""
        n = len(seeds)
        self.stats["seeds"] += n
        t0 = _time.perf_counter()
        left_q, left_t, right_q, right_t = [], [], [], []
        for s in seeds:
            read, rseq = s["read"], s["rseq"]
            qb, ro, sl = s["qbeg"], s["rbeg_off"], s["len"]
            # negative-stride VIEWS (no copies): _fill_tm's concat is the
            # only host copy on the whole pack path
            left_q.append(read[:qb][::-1])
            left_t.append(rseq[:ro][::-1])
            right_q.append(read[qb + sl :])
            right_t.append(rseq[ro + sl :])
        self.anatomy["prep_s"] += _time.perf_counter() - t0

        h0_left = [s["len"] for s in seeds]
        if self.mesh is None:
            # fused: one upload, on-device h0 chaining, one fetch
            lres, rres = self._run_fused(
                left_q, left_t, h0_left, right_q, right_t
            )
        else:
            lres = self._run(left_q, left_t, h0_left)
            rres = self._run(right_q, right_t, lres["score"])

        # vectorized gscore-vs-clip resolution (seed_proc semantics,
        # bwa-sw/sdaccel/smithwaterman.cpp:636-659)
        qb = np.array([s["qbeg"] for s in seeds], np.int64)
        rq_len = np.array([len(q) for q in right_q], np.int64)
        lsc, rsc = lres["score"], rres["score"]
        pen_clip = self.params.pen_clip
        l_clip = (lres["gscore"] <= 0) | (lres["gscore"] <= lsc - pen_clip)
        q_beg = np.where(l_clip, qb - lres["qle"], 0)
        r_beg = np.where(l_clip, -lres["tle"], -lres["gtle"])
        true_l = np.where(l_clip, lsc, lres["gscore"])
        r_clip = (rres["gscore"] <= 0) | (rres["gscore"] <= rsc - pen_clip)
        q_end = np.where(r_clip, rres["qle"], rq_len)
        r_end = np.where(r_clip, rres["tle"], rres["gtle"])
        true_score = true_l + np.where(r_clip, rsc, rres["gscore"]) - lsc
        width = np.maximum(lres["w"], rres["w"])
        return [
            dict(
                qBeg=int(q_beg[k]), qEnd=int(q_end[k]), rBeg=int(r_beg[k]),
                rEnd=int(r_end[k]), score=int(rsc[k]),
                trueScore=int(true_score[k]), width=int(width[k]),
            )
            for k in range(n)
        ]

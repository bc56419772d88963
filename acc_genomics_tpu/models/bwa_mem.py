"""BWA-MEM seeding + extension pipeline.

The composition the reference accelerates for bwa-flow: SMEM seeding
over the FM-index (mem_collect_intv, 40% of BWA-MEM runtime) followed by
banded Smith-Waterman extension of each seed (mem_chain2aln's
ksw_extend).  Chaining/pairing stay host-side concerns of the consumer;
this module turns reads into extended alignment candidates using the
batched device engines.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import jax
import numpy as np

from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu.ops.smem.index import FMIndex

TEXT_PAD = 512  # guard flanks so device span slices never clamp


@dataclasses.dataclass
class SeedHit:
    read_id: int
    qbeg: int
    qend: int
    rbeg: int  # text coordinate of alignment start
    rend: int
    score: int
    true_score: int
    width: int
    occ: int  # occurrence count of the originating SMEM


class BwaMemSeeding:
    def __init__(self, engine: GenomicsEngine, max_occ: int = 8, flank: int = 100):
        self.engine = engine
        self.max_occ = max_occ
        self.flank = flank

    def _positions(self, fm: FMIndex, iv) -> np.ndarray:
        """Text positions of an interval's occurrences via the SA."""
        rows = np.arange(iv["x0"], iv["x0"] + min(iv["s"], self.max_occ))
        return fm.sa[rows]

    def map_reads(self, reads: Sequence[np.ndarray]) -> List[List[SeedHit]]:
        fm = self.engine.smem.fm
        intervals = self.engine.smem_collect(list(reads))
        tasks = []
        meta = []
        text_len = fm.seq_len
        for rid, (read, ivs) in enumerate(zip(reads, intervals)):
            for iv in ivs:
                slen = iv["end"] - iv["start"]
                for pos in self._positions(fm, iv):
                    pos = int(pos)
                    span_lo = max(0, pos - iv["start"] - self.flank)
                    span_hi = min(text_len, pos + slen + (len(read) - iv["end"]) + self.flank)
                    rseq = fm.text[span_lo:span_hi]
                    tasks.append(
                        dict(
                            read=read,
                            rseq=rseq,
                            qbeg=iv["start"],
                            rbeg_off=pos - span_lo,
                            len=slen,
                        )
                    )
                    meta.append((rid, iv, pos, span_lo))
        results = self.engine.extend_seeds(tasks) if tasks else []
        out: List[List[SeedHit]] = [[] for _ in reads]
        for (rid, iv, pos, span_lo), res in zip(meta, results):
            out[rid].append(
                SeedHit(
                    read_id=rid,
                    qbeg=res["qBeg"],
                    qend=iv["end"] + res["qEnd"],
                    rbeg=pos + res["rBeg"],
                    rend=pos + (iv["end"] - iv["start"]) + res["rEnd"],
                    score=res["score"],
                    true_score=res["trueScore"],
                    width=res["width"],
                    occ=iv["s"],
                )
            )
        return out


# ---------------------------------------------------------------------------
# Device-resident pipeline: SA lookup + ref-span fetch + left/right
# extension fused into ONE device program — the accelerator form of the
# reference's on-chip chain_rseq_proc + seed_proc pipeline
# (bwa-sw/sdaccel/smithwaterman.cpp:276-672) with the pac preloaded once
# (BWAOCLEnv.h:11-56).  The host's only per-batch work is a vectorized
# seed enumeration over the fetched interval arrays; a read batch costs
# two device round trips (SMEM fetch + one fused extension call) instead
# of one per stage.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("wq", "wt", "flank", "params", "text_guard"),
)
def _extend_seeds_fused(
    sa, text_pad, text_len, seq_pad, rlens, rows, qbeg, slen, readid,
    wq: int, wt: int, flank: int, params, text_guard: int = TEXT_PAD,
):
    """One fused device step over N seed lanes.

    sa: (2L+1,) int32 suffix array (device-resident)
    text_pad: (2L + 2*TEXT_PAD,) uint8 indexed text with guard flanks
    seq_pad: (n_reads, wq + L_bucket + wq) uint8 reads with guard flanks
    rows/qbeg/slen/readid: (N,) int32 per-seed task arrays
    Returns (8, N) int32: qBeg qEndRel rBeg rEndRel score trueScore width pos.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch

    N = rows.shape[0]
    I32 = jnp.int32
    pos = jnp.take(sa, rows).astype(I32)  # (N,) text coordinate of seed
    rlen = jnp.take(rlens, readid)
    lq_len = qbeg
    rq_len = rlen - qbeg - slen
    lt_len = jnp.minimum(pos, qbeg + flank)
    rt_len = jnp.minimum(text_len - pos - slen, rq_len + flank)

    def slice2(arr2, rid, start, width):
        """(N,) gather of width-slices from rows of a 2D array."""
        return jax.vmap(
            lambda r, st: lax.dynamic_slice(arr2, (r, st), (1, width))[0]
        )(rid, start)

    def slice1(arr1, start, width):
        return jax.vmap(
            lambda st: lax.dynamic_slice(arr1, (st,), (width,))
        )(start)

    # queries: left = read[:qbeg] reversed; right = read[qbeg+slen:]
    lq = jnp.flip(slice2(seq_pad, readid, qbeg, wq), axis=1)  # read[qbeg-1-j]
    rq = slice2(seq_pad, readid, wq + qbeg + slen, wq)
    # targets from the padded text: left = text[pos-1-j], right = text[pos+slen+j]
    lt = jnp.flip(slice1(text_pad, text_guard + pos - wt, wt), axis=1)
    rt = slice1(text_pad, text_guard + pos + slen, wt)

    def run(q_nm, t_nm, ql, tl, h0):
        args = (
            q_nm.T.astype(I32), t_nm.T.astype(I32),
            ql.astype(I32), tl.astype(I32), h0.astype(I32),
            ql.astype(I32), ql.astype(I32),
        )
        return sw_extend_batch(*args, params=params)

    lres = run(lq, lt, lq_len, lt_len, slen)
    rres = run(rq, rt, rq_len, rt_len, lres["score"])

    pen = params.pen_clip
    lsc, rsc = lres["score"], rres["score"]
    l_clip = (lres["gscore"] <= 0) | (lres["gscore"] <= lsc - pen)
    q_beg = jnp.where(l_clip, qbeg - lres["qle"], 0)
    r_beg = jnp.where(l_clip, -lres["tle"], -lres["gtle"])
    true_l = jnp.where(l_clip, lsc, lres["gscore"])
    r_clip = (rres["gscore"] <= 0) | (rres["gscore"] <= rsc - pen)
    q_end = jnp.where(r_clip, rres["qle"], rq_len)
    r_end = jnp.where(r_clip, rres["tle"], rres["gtle"])
    true_score = true_l + jnp.where(r_clip, rsc, rres["gscore"]) - lsc
    width = jnp.maximum(lres["w"], rres["w"])
    return jnp.stack(
        [q_beg, q_end, r_beg, r_end, rsc, true_score, width, pos]
    ).astype(I32)


class BwaMemDevicePipeline:
    """Device-resident BWA-MEM seeding + extension.

    Equivalent results to :class:`BwaMemSeeding` (same seed enumeration
    policy, exact extension semantics), but the SA, the packed text, and
    the whole per-seed extension pipeline live on the device.
    """

    def __init__(self, engine: GenomicsEngine, max_occ: int = 8, flank: int = 100):
        self.engine = engine
        self.max_occ = max_occ
        self.flank = flank
        fm = engine.smem.fm
        self.fm = fm
        assert fm.seq_len < 2**31
        dev = engine.device
        # one-time residency (the BWAOCLEnv pac-preload analog)
        self.sa_dev = jax.device_put(fm.sa.astype(np.int32), dev)
        # guard flanks sized to the worst span slice width, so
        # dynamic_slice can never clamp near the text boundaries (a
        # clamped slice would silently shift the reference window)
        wt_max = -(-(engine.smem.config.seq_length + flank) // 64) * 64
        self.text_guard = max(TEXT_PAD, wt_max)
        tp = np.full(fm.seq_len + 2 * self.text_guard, 4, np.uint8)
        tp[self.text_guard : self.text_guard + fm.seq_len] = fm.text
        self.text_dev = jax.device_put(tp, dev)
        self.params = engine.extend.config.params()
        self.stats = {"reads": 0, "seeds": 0, "device_calls": 0}
        # per-phase anatomy (engine convention): smem = collect_arrays
        # (device + its fetch), enum = host seed enumeration/sort/pad,
        # extend = fused-step upload + dispatch + result fetch
        self.anatomy = dict(smem_s=0.0, enum_s=0.0, extend_s=0.0,
                            h2d_bytes=0, d2h_bytes=0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0.0 if k.endswith("_s") else 0

    def _lane_pad(self, n: int) -> int:
        b = 256
        while b < n:
            b *= 2
        return b

    def map_reads_arrays(self, reads: Sequence[np.ndarray]):
        """-> (hits (8, N) int32 [qBeg qEndRel rBeg rEndRel score trueScore
        width pos], seed readid (N,), seed meta (qbeg, slen, occ) arrays,
        host_read_idx routed to the dict path).  The array form is the
        fast path; map_reads wraps it into SeedHit lists."""
        import time as _t

        t0 = _t.perf_counter()

        eng = self.engine
        seq_len_bucket = eng.smem.config.seq_length
        max_rlen = max((len(r) for r in reads), default=0)
        for b in eng.smem.config.read_buckets:
            if max_rlen <= b:
                seq_len_bucket = b
                break
        n_reads = len(reads)
        self.stats["reads"] += n_reads
        seq_tm = np.full((seq_len_bucket, n_reads), 4, np.uint8)
        rlens = np.zeros(n_reads, np.int32)
        host_idx = []
        for k, r in enumerate(reads):
            if len(r) > seq_len_bucket:
                host_idx.append(k)
                continue
            seq_tm[: len(r), k] = r
            rlens[k] = len(r)

        mem, mem_n, overflow = eng.smem.collect_arrays(seq_tm, rlens)
        host_idx.extend(np.flatnonzero(overflow).tolist())
        t1 = _t.perf_counter()
        self.anatomy["smem_s"] += t1 - t0

        # vectorized seed enumeration (same order as the host model:
        # read-major, interval order, occurrence j ascending)
        used = mem.shape[1]
        if used == 0:
            return (np.zeros((8, 0), np.int32), np.zeros(0, np.int32),
                    (np.zeros(0, np.int32),) * 3, host_idx)
        valid = (np.arange(used)[None, :] < mem_n[:, None])  # (B, used)
        s_bi = mem[2].T  # (B, used)
        occ = np.where(valid, np.minimum(s_bi, self.max_occ), 0)
        occ_f = occ.reshape(-1)  # (B*used,) read-major
        tot = int(occ_f.sum())
        self.stats["seeds"] += tot
        if tot == 0:
            return (np.zeros((8, 0), np.int32), np.zeros(0, np.int32),
                    (np.zeros(0, np.int32),) * 3, host_idx)
        seed_iv = np.repeat(np.arange(len(occ_f)), occ_f)
        starts = np.concatenate(([0], np.cumsum(occ_f)[:-1]))
        j = np.arange(tot) - np.repeat(starts, occ_f)
        b_idx = (seed_iv // used).astype(np.int32)
        rows = (mem[0].T.reshape(-1)[seed_iv] + j).astype(np.int32)
        qbeg = mem[3].T.reshape(-1)[seed_iv].astype(np.int32)
        iend = mem[4].T.reshape(-1)[seed_iv].astype(np.int32)
        slen = iend - qbeg
        occ_per_seed = s_bi.reshape(-1)[seed_iv].astype(np.int32)

        wq = seq_len_bucket
        wt = -(-(seq_len_bucket + self.flank) // 64) * 64

        # pad lanes; padding seeds point at row 0 with zero lengths
        N = self._lane_pad(tot)
        pad = N - tot
        rows_p = np.concatenate([rows, np.zeros(pad, np.int32)])
        qbeg_p = np.concatenate([qbeg, np.zeros(pad, np.int32)])
        slen_p = np.concatenate([slen, np.zeros(pad, np.int32)])
        rid_p = np.concatenate([b_idx, np.zeros(pad, np.int32)])

        # guard-padded read matrix (n_reads, wq + L + wq)
        seq_pad = np.full((n_reads, wq + seq_len_bucket + wq), 4, np.uint8)
        seq_pad[:, wq : wq + seq_len_bucket] = seq_tm.T
        self.stats["device_calls"] += 1
        t2 = _t.perf_counter()
        self.anatomy["enum_s"] += t2 - t1
        self.anatomy["h2d_bytes"] += seq_pad.nbytes + rlens.nbytes + 4 * 4 * N
        put = lambda a: jax.device_put(a, self.engine.device)
        hits_dev = _extend_seeds_fused(
            self.sa_dev, self.text_dev, np.int32(self.fm.seq_len),
            put(seq_pad), put(rlens), put(rows_p), put(qbeg_p),
            put(slen_p), put(rid_p),
            wq=wq, wt=wt, flank=self.flank, params=self.params,
            text_guard=self.text_guard,
        )
        hits = np.asarray(hits_dev)[:, :tot]
        self.anatomy["d2h_bytes"] += 8 * 4 * N
        self.anatomy["extend_s"] += _t.perf_counter() - t2
        return hits, b_idx, (qbeg, slen, occ_per_seed), host_idx

    def map_reads(self, reads: Sequence[np.ndarray]) -> List[List[SeedHit]]:
        hits, rid, (qbeg, slen, occ), host_idx = self.map_reads_arrays(reads)
        out: List[List[SeedHit]] = [[] for _ in reads]
        host_set = set(host_idx)
        for t in range(hits.shape[1]):
            r = int(rid[t])
            if r in host_set:
                continue
            pos = int(hits[7, t])
            out[r].append(
                SeedHit(
                    read_id=r,
                    qbeg=int(hits[0, t]),
                    qend=int(qbeg[t] + slen[t]) + int(hits[1, t]),
                    rbeg=pos + int(hits[2, t]),
                    rend=pos + int(slen[t]) + int(hits[3, t]),
                    score=int(hits[4, t]),
                    true_score=int(hits[5, t]),
                    width=int(hits[6, t]),
                    occ=int(occ[t]),
                )
            )
        if host_set:
            host = BwaMemSeeding(self.engine, self.max_occ, self.flank)
            sub = host.map_reads([reads[k] for k in sorted(host_set)])
            for r, hlist in zip(sorted(host_set), sub):
                out[r] = [
                    dataclasses.replace(h, read_id=r) for h in hlist
                ]
        return out


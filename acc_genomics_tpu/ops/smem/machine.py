"""Batched SMEM collection as a flat per-lane state machine.

The accelerator redesign of the reference's 7-stage FPGA dataflow
(smem/device/smem.cpp: fe/afe/be/lfe/lbe stages arbitrated by a
``bwt_manager`` that owns all BWT DRAM reads).  The first port
(jax_impl.py) translated the control flow literally into nested vmapped
``lax.while_loop``s — under vmap every nesting level runs to the *max*
trip count over the batch, multiplying divergence across three levels.

Here the whole 3-pass ``mem_collect_intv_new`` pipeline is flattened
into ONE while_loop over a per-lane state machine: every iteration
issues exactly one batched FM-index probe (two occ lookups) for all
lanes — whatever pass/stage each lane is in — then takes one transition.
All lanes make progress every iteration, so the iteration count is the
max *total* probe count per read, not the product of per-loop maxima.
This is exactly the role of the reference's bwt_manager: stages issue
address requests into one arbitered DRAM stream (smem.cpp:2060-2124);
on the device the "arbiter" is XLA batching one gather over the lane
axis.

One probe = one 32-byte row gather from a fused (nblk, 8) int32 table
(4 occ checkpoint counts + 4 packed 2-bit words covering 64 bases) +
masked popcount — mirroring the reference's 64-byte occ-interleaved
blocks (smem/host/baseline.cpp bwt_occ4).

States follow the oracle (ops/smem/reference.py = baseline.cpp
bwt_smem1a_new / bwt_seed_strategy1 / mem_collect_intv_new); results are
compared EXACTLY against it in tests.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.ops.smem.index import FMIndex, OCC_INTERVAL
from acc_genomics_tpu.ops.smem.reference import (
    DEFAULT_SMEM_PARAMS,
    SmemParams,
)

I32 = jnp.int32
MAX_OUT = DEFAULT_SMEM_PARAMS.max_intv_alloc  # MAX_INTV_ALLOC default

# states — every machine iteration costs one probe-gather (~77% of the
# step), so bookkeeping-only park states were FOLDED into the probe
# steps that precede them in round 4: the back-chain epilogue (old
# S_BACK_POST) runs inline on S_BACK's stop step, the forwardenlarge
# outer loop (old S_FWDE_K) is absorbed by state-dependent back-row
# reads in S_BSTART/S_FWDE_M, and S_SKIP's exit runs S_BSTART's work
# inline.  The constants keep their values (jit caches, histograms).
S_P1_NEXTX = 0  # pass-1 driver: advance x to next base, enter FWD
S_FWD = 1       # forward extension collecting break intervals   [probe fwd]
S_BSTART = 2    # per-interval setup (reached from S_FWD only: its curr[0]
                # row is written on the to_back step itself)
S_BACK = 3      # backward chain; stop step runs the epilogue    [probe back]
S_BACK_POST = 4 # retired (folded into S_BACK's stop step, round 4)
S_FWDE_K = 5    # retired (folded into S_BSTART / S_FWDE_M, round 4)
S_FWDE_M = 6    # forwardenlarge inner; reloads back[k-1] on fail [probe fwd]
S_SKIP = 7      # skip-ahead over hopeless intervals; exits run BSTART inline
S_P2_NEXT = 8   # pass-2 driver: re-seed long low-occ SMEMs from midpoints
S_P3_NEXTX = 9  # pass-3 driver
S_P3_EXT = 10   # LAST-like strategy extension                   [probe fwd]
S_DONE = 11
N_STATES = 12
# (A unique-interval s==1 text-comparison fast path and a host-driven
# streaming-refill machine were built, proven exact, and measured
# NEGATIVE/neutral at genome scale — pruned; the negative results are
# listed in PERF.md.  The step-count
# lever that replaced them is multi-read lanes: reads_per_lane below.)


def device_index_fused(fm: FMIndex, occ_rate: int = 64):
    """Fused probe table, one row gather per occ probe.

    ``occ_rate`` is the checkpoint interval:
      64 -> row = [cnt0..3, word0..3] (8 int32, 32 B; matches the
            FMIndex on-disk blocks) — the DEFAULT.
      16 -> row = [cnt0..2, word] (4 int32, 16 B): 4th count derived
            (cnt3 = 16*blk - cnt0 - cnt1 - cnt2), one packed word.
            Measured slower in-machine than the 8-wide row on the
            platform this engine was first built for, although an
            isolated gather favoured it; not measured on the GPU.  Kept
            as an option for other table scales.
    """
    assert fm.seq_len < 2**31
    nblk = fm.bwt_packed.shape[0]
    if occ_rate == 64:
        tbl = np.empty((nblk, 8), np.int32)
        tbl[:, :4] = fm.occ_ckpt[:nblk].astype(np.int32)
        tbl[:, 4:] = fm.bwt_packed.view(np.int32)
    elif occ_rate == 16:
        n16 = nblk * 4  # four 16-base sub-blocks per stored 64-block
        words = fm.bwt_packed.reshape(-1)  # (nblk*4,) uint32
        # cumulative counts at each 16-base boundary: stored 64-ckpt +
        # popcount prefix of the sub-block words before it
        tbl = np.empty((n16, 4), np.int32)
        sub = np.zeros((4, nblk, 3), np.int64)  # prefix counts per base
        w = fm.bwt_packed  # (nblk, 4) uint32
        for c in range(3):
            pat = np.uint32(0x55555555 * c)
            nx = ~(w ^ pat)
            y = nx & (nx >> np.uint32(1)) & np.uint32(0x55555555)
            cnt = np.zeros(w.shape, np.int64)
            yy = y
            while yy.any():  # popcount via vectorized bit trick
                cnt += yy & 1
                yy = yy >> np.uint32(1)
            np.cumsum(cnt[:, :3], axis=1, out=sub[1:, :, c].transpose(1, 0))
        base = fm.occ_ckpt[:nblk, :3].astype(np.int64)  # (nblk, 3)
        cnts = base[None, :, :] + sub  # (4, nblk, 3)
        tbl[:, :3] = cnts.transpose(1, 0, 2).reshape(n16, 3).astype(np.int32)
        tbl[:, 3] = words.view(np.int32)
    else:
        raise ValueError(f"occ_rate must be 16 or 64, got {occ_rate}")
    return dict(
        l2=jnp.asarray(fm.L2.astype(np.int32)),
        primary=jnp.asarray(np.int32(fm.primary)),
        tbl=jnp.asarray(tbl),
    )


def _occ_rate(tbl):
    """Checkpoint interval from the (static) table width."""
    return 64 if tbl.shape[1] == 8 else 16


def _occ_pos(primary, k, rate=OCC_INTERVAL):
    """BWT position k -> (probe-table row, in-block offset, valid)."""
    valid = k >= 0
    kk = k - (k >= primary).astype(I32)
    kk = jnp.maximum(kk, 0)
    return kk // rate, kk % rate, valid


def _popc2(w, pat, mask):
    """Count 2-bit groups equal to pat in w & mask (w uint32)."""
    nx = ~(w ^ pat)
    y = nx & (nx >> 1) & jnp.uint32(0x55555555)
    return jax.lax.population_count(y & mask)


def _occ4_from_row(row, off, valid, blk=None):
    """(B, 4) occ counts from a gathered probe row + in-block offset.

    Width-8 rows: [cnt0..3, word0..3] (64-base blocks).  Width-4 rows:
    [cnt0..2, word] (16-base blocks; cnt3 derived from blk)."""
    if row.shape[1] == 4:
        cnt3 = blk * 16 - row[:, 0] - row[:, 1] - row[:, 2]
        w = jax.lax.bitcast_convert_type(row[:, 3], jnp.uint32)  # (B,)
        keep = jnp.clip(off + 1, 0, 16)
        sh = jnp.clip(32 - 2 * keep, 0, 31).astype(jnp.uint32)
        mask = jnp.where(
            keep == 0, jnp.uint32(0), jnp.uint32(0xFFFFFFFF) << sh
        )
        outs = []
        for c in range(4):
            cc = _popc2(w, jnp.uint32(0x55555555 * c), mask).astype(I32)
            base = cnt3 if c == 3 else row[:, c]
            outs.append(base + cc)
        out = jnp.stack(outs, axis=1)
        return jnp.where(valid[:, None], out, 0)
    cnt = row[:, :4]
    w = jax.lax.bitcast_convert_type(row[:, 4:], jnp.uint32)  # (B, 4)
    m_idx = jnp.arange(4, dtype=I32)[None, :]
    keep = jnp.clip(off[:, None] + 1 - 16 * m_idx, 0, 16)
    sh = jnp.clip(32 - 2 * keep, 0, 31).astype(jnp.uint32)
    mask = jnp.where(keep == 0, jnp.uint32(0), jnp.uint32(0xFFFFFFFF) << sh)
    outs = []
    for c in range(4):
        cc = _popc2(w, jnp.uint32(0x55555555 * c), mask).sum(
            axis=1, dtype=jnp.uint32
        ).astype(I32)
        outs.append(cnt[:, c] + cc)
    out = jnp.stack(outs, axis=1)
    return jnp.where(valid[:, None], out, 0)


def _occ4_batch(tbl, primary, k):
    """(B, 4) counts of each base among the first k+1 BWT rows; k (B,)."""
    blk, off, valid = _occ_pos(primary, k, _occ_rate(tbl))
    row = jnp.take(tbl, blk, axis=0)  # (B, width) — the one probe
    return _occ4_from_row(row, off, valid, blk)


# When True, the two occ probes per machine iteration (interval head and
# tail) are issued as ONE (2B,)-index row gather instead of two (B,)
# gathers — the gather unit's cost is per-invocation more than per-row
# (A/B'd at 100 Mbp, benchmarks/smem_fused_probe_ab.py).  Module-level so
# the A/B harness can trace both variants; the bits are identical.
FUSED_PROBE = True

# Diagnostic: when True, the machine carries a (12,) per-state lane-count
# histogram (summed over iterations) returned as a 4th output.  Costs one
# extra one-hot sum per step — off in production; the A/B harnesses flip
# it to attribute iteration counts to states (probe vs bookkeeping).
STATE_HIST = False


def _occ4_pair(tbl, primary, ka, kb):
    """occ4 at two positions per lane via one fused row gather."""
    out = _occ4_batch(tbl, primary, jnp.concatenate([ka, kb]))
    B = ka.shape[0]
    return out[:B], out[B:]


def _extend_from_occ(xo, xf, s, is_back, tk, tl, l2, primary):
    """bwt_extend arithmetic from the two occ results (shared tail)."""
    oks = tl - tk
    cnt_coord = l2[None, :4] + 1 + tk
    span = ((xf <= primary) & (xf + s - 1 >= primary)).astype(I32)
    # suffix-inclusive sums in complement order T,G,C,A (4 explicit adds)
    s3 = oks[:, 3]
    s2 = s3 + oks[:, 2]
    s1 = s2 + oks[:, 1]
    s0 = s1 + oks[:, 0]
    suff_incl = jnp.stack([s0, s1, s2, s3], axis=1)
    oth = xo[:, None] + span[:, None] + (suff_incl - oks)
    ib = is_back[:, None]
    o0 = jnp.where(ib, cnt_coord, oth)
    o1 = jnp.where(ib, oth, cnt_coord)
    return o0, o1, oks


def _extend_batch(idx, x0, x1, s, is_back):
    """Bidirectional extension for all 4 bases, per-lane direction.

    Returns (o0, o1, os) each (B, 4) — bwt_extend semantics
    (smem/host/baseline.cpp:87-100)."""
    tbl, primary, l2 = idx["tbl"], idx["primary"], idx["l2"]
    xf = jnp.where(is_back, x0, x1)
    xo = jnp.where(is_back, x1, x0)
    if FUSED_PROBE:
        tk, tl = _occ4_pair(tbl, primary, xf - 1, xf - 1 + s)
    else:
        tk = _occ4_batch(tbl, primary, xf - 1)
        tl = _occ4_batch(tbl, primary, xf - 1 + s)
    return _extend_from_occ(xo, xf, s, is_back, tk, tl, l2, primary)


def _read_row(buf, row):
    """buf (L, B), row (B,) -> (B,): value at (row[b], b); 0 out of range."""
    io = jax.lax.broadcasted_iota(I32, buf.shape, 0)
    return jnp.sum(jnp.where(io == row[None, :], buf, 0), axis=0, dtype=I32)


def _write_row(buf, row, val, mask):
    """Set buf[row[b], b] = val[b] where mask[b] (row must be in range)."""
    io = jax.lax.broadcasted_iota(I32, buf.shape, 0)
    w = (io == row[None, :]) & mask[None, :]
    return jnp.where(w, val[None, :].astype(buf.dtype), buf)


def _pick(c, arr4):
    """arr4 (B,4) -> (B,) at clipped base c."""
    cc = jnp.clip(c, 0, 3)[:, None]
    io = jax.lax.broadcasted_iota(I32, arr4.shape, 1)
    return jnp.sum(jnp.where(io == cc, arr4, 0), axis=1, dtype=I32)


def smem_collect_machine(idx, seq_tm, lens, max_iters=None,
                         params: SmemParams = DEFAULT_SMEM_PARAMS,
                         reads_per_lane: int = 1):
    """Batched 3-pass SMEM collection via the flat state machine.

    seq_tm: (L, B) int32 read codes (pad 4), time-major; lens: (B,)
    params: static runtime options (mem_opt_t analog)
    Returns (mem arrays (mem_cap, B) x5, mem_n (B,), iters scalar);
    mem_n > max_intv_alloc marks unfinished/overflow/bust lanes (host
    rerun contract) and can exceed the carried mem_cap rows.

    Multi-read mode (``reads_per_lane`` = Q > 1): each lane processes Q
    reads SEQUENTIALLY.  seq_tm is the PRE-PACKED plane
    (3*Q*L/32, B) int32 — Q*L/16 rows of 2-bit base words (16 bases
    per word, MSB-first) stacked over Q*L/32 rows of N-bitmask words,
    packed by the engine host-side (uploading packed planes is ~2.6x
    fewer bytes than uint8, and seq reads inside the loop cost plane
    rows, so packed is also cheaper per step).  L must be a multiple of
    32; lane b's read q occupies bit positions [q*L, q*L+L).  lens is
    (Q, B).  A lane finishing read q switches to
    read q+1 in-body (registers reset, outputs keep appending to the
    lane's mem column; per-read boundaries land in ``bnd``).  The while
    iteration count is then bound by the max over lanes of the SUM of Q
    per-read step counts — sums of iid draws concentrate (~1/sqrt(Q)
    relative spread), so throughput approaches the MEAN per-read cost
    instead of the batch max (measured: mean 631 vs max 1378 steps at
    101 bp/100 Mbp — the 54% DONE-wait this mode exists to kill).  This
    is the device analog of the reference streaming reads through
    resident PEs (smem/device/smem.cpp input_dup / MAX_TILE_SIZE=16
    in-flight reads per stage).  Returns (mem x5, mem_n, bnd (Q, B),
    bustq (Q, B), iters): read (q, b)'s intervals are mem rows
    [bnd[q-1, b], bnd[q, b]) of lane b (row Q-1 boundary = mem_n);
    bustq marks per-read host reruns.
    """
    Q = int(reads_per_lane)
    MIN_SEED_LEN = params.min_seed_len
    SPLIT_LEN = params.split_len
    SPLIT_WIDTH = params.split_width
    MAX_MEM_INTV = params.max_mem_intv
    MAX_OUT = params.max_intv_alloc
    if Q > 1:
        R, B = seq_tm.shape
        QL = R * 32 // 3  # packed rows: QL/16 words + QL/32 nmask
        L = QL // Q
        assert 3 * QL == 32 * R and L % 32 == 0 and lens.shape == (Q, B)
    else:
        L, B = seq_tm.shape
    # curr/back buffer rows: the while-carry traffic on the (rows, B)
    # interval buffers dominates the per-iteration cost, so they are
    # capped below the worst case (one break interval per base).  Lanes
    # whose chains outgrow the cap are flagged and rerun on the host —
    # the same graceful-degradation contract as interval overflow.
    LB = min(L + 1, max(params.curr_cap, 8))
    # output-buffer rows in the carry: real reads push ~6 intervals, so
    # carrying max_intv_alloc rows multiplies every masked mem write by
    # 4-8x for nothing; lanes that push past the cap -> host rerun
    MM = min(max(params.mem_cap, 8), MAX_OUT)
    if max_iters is None:
        # total probes+transitions per read is bounded by a small multiple
        # of its length per pass; 64x is a generous safety cap
        max_iters = (64 * L + 4096) * Q

    if Q > 1:
        # per-lane CURRENT read length rides the carry (switch updates
        # it); lens stays resident as an (Q, B) buffer for the switch
        lens_q = lens.astype(I32)
        ln0 = lens_q[0]
        zb = ln0 * 0
        QLp = QL
        seq_words = seq_tm[: QL // 16]
        seq_nmask = seq_tm[QL // 16 :]
    else:
        seq_tm = seq_tm.astype(I32)  # hosts upload uint8 (uint8 compute A/B'd neutral)
        ln = lens.astype(I32)
        zb = ln * 0
    # derive all carry zeros from the inputs so they inherit the varying
    # mesh axes under shard_map (carry in/out types must match exactly)
    zeros_lb = jnp.zeros((LB, B), I32) + zb[None, :]
    zeros_mm = jnp.zeros((MM, B), I32) + zb[None, :]
    # read positions fit int16 (<= L <= 32767): halving those planes cuts
    # the while-carry HBM traffic, the dominant per-iteration cost
    zeros_lb16 = zeros_lb.astype(jnp.int16)
    zeros_mm16 = zeros_mm.astype(jnp.int16)

    ln_init = lens_q[0] if Q > 1 else ln
    init = dict(
        st=jnp.where(ln_init > 0, S_P1_NEXTX, S_DONE).astype(I32),
        x=zb, i=zb, ic=zb, k=zb, m=zb,
        mode=zb + 1, min_intv=zb + 1,
        p2_k=zb, p2_old_n=zb,
        curr_n=zb, back_n=zb, mem_n=zb,
        start=zb, stop=zb, ret=zb,
        skip_first=zb > 0,
        bust=zb > 0,  # curr/back chain outgrew the capped buffers
        ik0=zb, ik1=zb, iks=zb, ikst=zb, iken=zb,
        t0=zb, t1=zb, t2=zb, t3=zb, t4=zb,
        cu0=zeros_lb, cu1=zeros_lb, cu2=zeros_lb, cu3=zeros_lb16,  # x0,x1,s,end
        bk0=zeros_lb, bk1=zeros_lb, bk2=zeros_lb, bk3=zeros_lb16, bk4=zeros_lb16,
        mm0=zeros_mm, mm1=zeros_mm, mm2=zeros_mm, mm3=zeros_mm16, mm4=zeros_mm16,
        iters=jnp.max(zb),  # varying scalar under shard_map
    )
    # multi-read hot push buffer: mem pushes land in HOT small rows and
    # bulk-flush into the main (MM, B) planes once per HOT machine steps
    # (pushes are <= 1/lane/step, so HOT slots never overflow between
    # flushes).  The main planes then pay their full-plane masked-write
    # RMW once per HOT steps instead of every step — multi-read mode
    # carries Q*~8 rows, whose per-step writes would otherwise eat the
    # step-count win.  HOT=8 was tuned on the engine's first platform and
    # is kept until a sweep on the GPU.  HOT doubles
    # as the unroll depth; 2 on CPU to keep the test-ladder compile small.
    HOT = 2 if jax.devices()[0].platform == "cpu" else 8
    if Q > 1:
        init["ln"] = ln_init          # current read length per lane
        init["q"] = zb                # current read index per lane
        init["mem_base"] = zb         # lane's mem_n at current-read start
        init["bnd"] = zeros_mm16[:1] * 0 + jnp.zeros((Q, B), jnp.int16)
        init["bq"] = jnp.zeros((Q, B), bool) | (zb > 0)[None, :]
        init["hn"] = zb               # hot pushes since last flush
        zeros_hot = jnp.zeros((HOT, B), I32) + zb[None, :]
        init["h0"] = zeros_hot
        init["h1"] = zeros_hot
        init["h2"] = zeros_hot
        init["h3"] = zeros_hot.astype(jnp.int16)
        init["h4"] = zeros_hot.astype(jnp.int16)
    if STATE_HIST:
        init["hist"] = jnp.zeros((N_STATES,), I32)
        init["live_t"] = zb  # per-lane live (non-DONE) step count

    def _hist_add(n, st):
        if STATE_HIST:
            n["hist"] = n["hist"] + jnp.sum(
                st[None, :] == jnp.arange(N_STATES, dtype=I32)[:, None],
                axis=1, dtype=I32,
            )
            n["live_t"] = n["live_t"] + (st != S_DONE).astype(I32)

    l2 = idx["l2"]

    def seq_at(pos, s=None):
        """seq[pos] of the lane's CURRENT read; 4 (N / out of range) when
        pos outside [0, ln).  Q > 1 reads the packed word + N-bit planes
        (2-bit extraction; plane cost Q*L/16 + Q*L/32 rows instead of
        Q*L)."""
        if Q > 1:
            pa = jnp.clip(s["q"] * L + pos, 0, QLp - 1)
            wrow = pa >> 4
            io = jax.lax.broadcasted_iota(I32, seq_words.shape, 0)
            w = jnp.sum(
                jnp.where(io == wrow[None, :], seq_words, 0), axis=0, dtype=I32
            )
            code = (w >> (2 * (15 - (pa & 15)))) & 3
            nrow = pa >> 5
            io2 = jax.lax.broadcasted_iota(I32, seq_nmask.shape, 0)
            nw = jnp.sum(
                jnp.where(io2 == nrow[None, :], seq_nmask, 0), axis=0, dtype=I32
            )
            nb = (nw >> (31 - (pa & 31))) & 1
            return jnp.where(
                (pos >= 0) & (pos < s["ln"]) & (nb == 0), code, 4
            )
        io = jax.lax.broadcasted_iota(I32, seq_tm.shape, 0)
        hit = io == jnp.clip(pos, 0, L - 1)[None, :]
        v = jnp.sum(jnp.where(hit, seq_tm, 0), axis=0, dtype=I32)
        return jnp.where((pos >= 0) & (pos < ln), v, 4)

    def cond(s):
        return jnp.any(s["st"] != S_DONE) & (s["iters"] < max_iters)

    # The machine runs as THREE sequential while_loops — one per
    # mem_collect_intv pass — instead of one flat loop over all 12
    # states.  Rationale (measured): the per-iteration cost is dominated
    # by elementwise work + carry traffic over the (rows, B) buffers, so
    # each phase's body only touches the buffers its states can reach:
    # pass 1 never reads mem rows, pass 3 (the LAST-like scan) needs no
    # curr/back machinery at all.  Lanes still advance one probe per
    # iteration within each phase; iteration counts are unchanged, the
    # bodies just shrink.
    #
    # The STREAMING engine instead needs every pass in ONE body so a
    # segment can resume any lane anywhere (make_body12(include_p3=True));
    # per-lane pass barriers disappear there, which is strictly fewer
    # iterations per lane.

    def _p3_updates(s, upd, st, rd_is_base, oc0f, oc1f, ocsf, ix0, ix1,
                    isz, lnc):
        """Pass-3 (LAST-like scan) state updates, shared by the split
        body3 and the unified multi-read body.  Returns the mem-push mask
        (the caller owns the mem write so it can merge pushes)."""
        is_p3x = st == S_P3_NEXTX
        is_p3e = st == S_P3_EXT

        # ================= S_P3_NEXTX =================
        p3_done = is_p3x & (s["x"] >= lnc)
        p3_enter = is_p3x & (s["x"] < lnc) & rd_is_base
        p3_step = is_p3x & (s["x"] < lnc) & ~rd_is_base
        upd("st", p3_done, jnp.full_like(st, S_DONE))
        upd("st", p3_enter, jnp.full_like(st, S_P3_EXT))
        upd("ik0", p3_enter, ix0)
        upd("ik1", p3_enter, ix1)
        upd("iks", p3_enter, isz)
        upd("i", p3_enter, s["x"] + 1)
        upd("x", p3_step, s["x"] + 1)

        # ================= S_P3_EXT =================
        p3_out = is_p3e & (s["i"] >= lnc)  # exhausted: no seed
        p3_n = is_p3e & (s["i"] < lnc) & ~rd_is_base  # N: stop, x = i+1
        p3_base = is_p3e & (s["i"] < lnc) & rd_is_base
        hit = p3_base & (ocsf < MAX_MEM_INTV) & ((s["i"] - s["x"]) >= MIN_SEED_LEN)
        p3_go = p3_base & ~hit
        upd("x", p3_out, lnc)
        upd("x", p3_n | hit, s["i"] + 1)
        upd("st", p3_out | p3_n | hit, jnp.full_like(st, S_P3_NEXTX))
        upd("ik0", p3_go, oc0f)
        upd("ik1", p3_go, oc1f)
        upd("iks", p3_go, ocsf)
        upd("i", p3_go, s["i"] + 1)
        return hit & (ocsf > 0)

    def make_body12(include_p3=False):
        """smem1a machinery + the pass-1 and pass-2 drivers in ONE loop:
        lanes flow from pass 1 straight into pass 2, so the iteration
        count stays max over lanes of (p1 + p2) steps — a p1/p2 barrier
        measured 20% slower than this combined form.  Multi-read (Q > 1)
        uses include_p3=True so lanes flow p1 -> p2 -> p3 -> next read."""

        def body(s):
            st = s["st"]
            lnc = s["ln"] if Q > 1 else ln
            is_p1x = st == S_P1_NEXTX
            is_p2 = st == S_P2_NEXT
            is_fwd = st == S_FWD
            is_bst = st == S_BSTART
            is_bck = st == S_BACK
            is_fem = st == S_FWDE_M
            is_skp = st == S_SKIP

            # ---- shared reads ---------------------------------------------
            # curr row: BSTART/SKIP read interval ic; BACK reads ic+1 (its
            # stop step runs the old BACK_POST epilogue inline, which
            # needs the NEXT interval's end — round-4 state folds)
            curr_row = jnp.where(is_bck, s["ic"] + 1, s["ic"])
            c_x0 = _read_row(s["cu0"], curr_row)
            c_x1 = _read_row(s["cu1"], curr_row)
            c_s = _read_row(s["cu2"], curr_row)
            c_end = _read_row(s["cu3"], curr_row)
            # back row: BSTART/SKIP-exit read back[back_n-1] (inner-loop
            # entry), FWDE_M reads back[k-1] (inner-loop failure reload);
            # out-of-range rows read 0s and are consumed by no lane
            b_row = jnp.where(
                is_bst | is_skp,
                s["back_n"] - 1,
                jnp.where(is_fem, s["k"] - 1, s["k"]),
            )
            b_x0 = _read_row(s["bk0"], b_row)
            b_x1 = _read_row(s["bk1"], b_row)
            b_s = _read_row(s["bk2"], b_row)
            b_st = _read_row(s["bk3"], b_row)
            b_en = _read_row(s["bk4"], b_row)
            # mem row p2_k (pass-2 driver); in multi-read mode the most
            # recent pushes still sit in the hot buffer — row p2_k lives
            # in hot when p2_k >= mem_n - hn (overrides the main read)
            p_s = _read_row(s["mm2"], s["p2_k"])
            p_st = _read_row(s["mm3"], s["p2_k"])
            p_en = _read_row(s["mm4"], s["p2_k"])
            if Q > 1:
                rel = s["p2_k"] - (s["mem_n"] - s["hn"])
                in_hot = (rel >= 0) & (rel < s["hn"])
                p_s = jnp.where(in_hot, _read_row(s["h2"], rel), p_s)
                p_st = jnp.where(in_hot, _read_row(s["h3"], rel), p_st)
                p_en = jnp.where(in_hot, _read_row(s["h4"], rel), p_en)
            mid = (p_st + p_en) >> 1

            # one sequence read per lane, position selected by state
            pos = jnp.where(is_fwd, s["i"], s["x"])
            pos = jnp.where(is_bck, s["k"], pos)
            pos = jnp.where(is_fem, s["m"] - 1, pos)
            pos = jnp.where(is_p2, mid, pos)
            if include_p3:
                pos = jnp.where(st == S_P3_EXT, s["i"], pos)
            rd = seq_at(pos, s)
            rd_is_base = rd < 4

            # ---- the one batched probe (bwt_manager analog) ----------------
            o0, o1, osz = _extend_batch(
                idx, s["ik0"], s["ik1"], s["iks"], is_bck
            )
            # forward states consume complement base, backward the base
            c_fwd = 3 - rd
            oc0f, oc1f, ocsf = _pick(c_fwd, o0), _pick(c_fwd, o1), _pick(c_fwd, osz)
            oc0b, oc1b, ocsb = _pick(rd, o0), _pick(rd, o1), _pick(rd, osz)

            n = dict(s)
            n["iters"] = s["iters"] + 1
            _hist_add(n, st)

            def upd(key, mask, val):
                n[key] = jnp.where(mask, val, n[key])

            # helper: push current values into curr buffers (overflowing
            # the capped buffer flags the lane for host rerun)
            def push_curr(mask, v0, v1, v2, v3):
                slot = jnp.minimum(s["curr_n"], LB - 1)
                n["cu0"] = _write_row(n["cu0"], slot, v0, mask)
                n["cu1"] = _write_row(n["cu1"], slot, v1, mask)
                n["cu2"] = _write_row(n["cu2"], slot, v2, mask)
                n["cu3"] = _write_row(n["cu3"], slot, v3, mask)
                upd("curr_n", mask, s["curr_n"] + 1)
                n["bust"] = n["bust"] | (mask & (s["curr_n"] >= LB))
                upd("ret", mask, v3)  # ret = end of last pushed break intv

            # helper: push temp into mem (count past the carried-buffer
            # cap -> bust -> host rerun).  Multi-read pushes go to the
            # HOT buffer (flushed to the main planes every HOT steps)
            def push_mem(mask, v0, v1, v2, v3, v4, nkey="mem_n"):
                cnt = n[nkey]
                w = mask & (cnt < MM)
                if Q > 1:
                    slot = jnp.minimum(n["hn"], HOT - 1)
                    n["h0"] = _write_row(n["h0"], slot, v0, w)
                    n["h1"] = _write_row(n["h1"], slot, v1, w)
                    n["h2"] = _write_row(n["h2"], slot, v2, w)
                    n["h3"] = _write_row(n["h3"], slot, v3, w)
                    n["h4"] = _write_row(n["h4"], slot, v4, w)
                    n["hn"] = jnp.where(w, n["hn"] + 1, n["hn"])
                else:
                    slot = jnp.minimum(cnt, MM - 1)
                    n["mm0"] = _write_row(n["mm0"], slot, v0, w)
                    n["mm1"] = _write_row(n["mm1"], slot, v1, w)
                    n["mm2"] = _write_row(n["mm2"], slot, v2, w)
                    n["mm3"] = _write_row(n["mm3"], slot, v3, w)
                    n["mm4"] = _write_row(n["mm4"], slot, v4, w)
                n["bust"] = n["bust"] | (mask & (cnt >= MM))
                n[nkey] = jnp.where(mask, cnt + 1, cnt)

            ix0 = jnp.take(l2, jnp.clip(rd, 0, 3)) + 1
            ix1 = jnp.take(l2, jnp.clip(3 - rd, 0, 3)) + 1
            isz = jnp.take(l2, jnp.clip(rd, 0, 3) + 1) - jnp.take(
                l2, jnp.clip(rd, 0, 3)
            )

            # ================= S_P1_NEXTX =================
            p1_done = is_p1x & (s["x"] >= lnc)
            p1_enter = is_p1x & (s["x"] < lnc) & rd_is_base
            p1_step = is_p1x & (s["x"] < lnc) & ~rd_is_base
            # -> pass-2 driver init: scan starts at the CURRENT read's
            # first mem row (0 for Q == 1; the lane's mem_base in
            # multi-read mode, where mem_n accumulates across reads)
            upd("st", p1_done, jnp.full_like(st, S_P2_NEXT))
            upd("p2_old_n", p1_done, s["mem_n"])
            upd("p2_k", p1_done, s["mem_base"] if Q > 1 else zb)
            # -> enter smem1a at x (min_intv=1, mode=1): init FWD
            enter_any = p1_enter
            upd("st", p1_enter, jnp.full_like(st, S_FWD))
            upd("min_intv", p1_enter, jnp.ones_like(zb))
            upd("mode", p1_enter, jnp.ones_like(zb))
            upd("x", p1_step, s["x"] + 1)

            # ================= S_P2_NEXT =================
            p2_done = is_p2 & (s["p2_k"] >= s["p2_old_n"])
            p2_live = is_p2 & (s["p2_k"] < s["p2_old_n"])
            qual = (
                (p_en - p_st >= SPLIT_LEN)
                & (p_s <= SPLIT_WIDTH)
                & (s["p2_k"] < MAX_OUT)
            )
            p2_enter = p2_live & qual & rd_is_base  # rd = seq[mid]
            p2_step = p2_live & ~(qual & rd_is_base)
            if include_p3:
                # unified body: flow straight into the pass-3 scan (the
                # split flow parks the lane and a second while runs body3)
                upd("st", p2_done, jnp.full_like(st, S_P3_NEXTX))
                upd("x", p2_done, zb)
                upd("i", p2_done, zb)
                upd("ik0", p2_done, zb)
                upd("ik1", p2_done, zb)
                upd("iks", p2_done, zb)
            else:
                upd("st", p2_done, jnp.full_like(st, S_DONE))
            upd("st", p2_enter, jnp.full_like(st, S_FWD))
            upd("x", p2_enter, mid)
            upd("min_intv", p2_enter, p_s + 1)
            upd("mode", p2_enter, zb + 2)
            upd("p2_k", p2_enter | p2_step, s["p2_k"] + 1)
            enter_any = enter_any | p2_enter
            new_x = jnp.where(p2_enter, mid, s["x"])

            # shared smem1a-entry register init (x already set per path)
            upd("i", enter_any, new_x + 1)
            upd("curr_n", enter_any, zb)
            upd("back_n", enter_any, zb)
            upd("ik0", enter_any, ix0)
            upd("ik1", enter_any, ix1)
            upd("iks", enter_any, isz)
            upd("ikst", enter_any, zb)
            upd("iken", enter_any, new_x + 1)
            upd("start", enter_any, new_x)
            upd("stop", enter_any, new_x)

            # ================= S_FWD =================
            fwd_end = is_fwd & ((s["i"] >= lnc) | ~rd_is_base)  # exhausted or N
            fwd_ext = is_fwd & (s["i"] < lnc) & rd_is_base
            changed = ocsf != s["iks"]
            fwd_brk = fwd_ext & changed & (ocsf < s["min_intv"])
            fwd_go = fwd_ext & ~fwd_brk
            # pushes: at end/N push current ik; on change push current ik
            push_curr(
                fwd_end | (fwd_ext & changed),
                s["ik0"], s["ik1"], s["iks"], s["iken"],
            )
            # advance ik on non-break extension
            upd("ik0", fwd_go, oc0f)
            upd("ik1", fwd_go, oc1f)
            upd("iks", fwd_go, ocsf)
            upd("iken", fwd_go, s["i"] + 1)
            upd("i", fwd_go, s["i"] + 1)
            # to backward phase
            to_back = fwd_end | fwd_brk
            upd("st", to_back, jnp.full_like(st, S_BSTART))
            upd("ic", to_back, zb)
            # start/stop already x from entry init

            # ---- S_SKIP masks (early: its exit runs BSTART inline) --------
            skp_done = is_skp & (s["ic"] >= s["curr_n"])
            skp_live = is_skp & ~skp_done
            max_len = s["t3"] + c_end
            skp_more = skp_live & (max_len < MIN_SEED_LEN)
            skp_exit = skp_live & ~skp_more
            # stop as BSTART would see it one step later: continuation
            # SKIP iterations update stop = curr[ic].end first
            stop_eff = jnp.where(is_skp & ~s["skip_first"], c_end, s["stop"])

            # ================= S_BSTART (+ folded SKIP exits) ===========
            # Round-4 fold: SKIP's exit used to park one full probe-step
            # in S_BSTART; its work now runs inline on the exit step.
            # S_BSTART itself remains only as S_FWD's landing state (its
            # curr[0] row is written on the to_back step itself, so the
            # read must wait one step).
            bst_any = is_bst | skp_exit
            use_back = (s["back_n"] == 0) | (stop_eff - s["start"] >= 3)
            bst_back = bst_any & use_back
            bst_fwde = bst_any & ~use_back
            upd("ik0", bst_any, jnp.where(bst_fwde, b_x0, c_x0))
            upd("ik1", bst_any, jnp.where(bst_fwde, b_x1, c_x1))
            upd("iks", bst_any, jnp.where(bst_fwde, b_s, c_s))
            upd("ikst", bst_any, jnp.where(bst_fwde, b_st, s["x"]))
            upd("iken", bst_any, jnp.where(bst_fwde, b_en, c_end))
            # backenlarge: back = [ik]; k = x-1  (the bk write itself is
            # merged with S_BACK's below — exclusive states)
            upd("back_n", bst_back, jnp.ones_like(zb))
            upd("k", bst_back, s["x"] - 1)
            upd("st", bst_back, jnp.full_like(st, S_BACK))
            # forwardenlarge: stop = curr[ic].end, registers loaded from
            # back[back_n-1], straight into the inner loop (the old
            # S_FWDE_K entry park step — folded round 4)
            upd("stop", bst_fwde, c_end)
            upd("k", bst_fwde, s["back_n"] - 1)
            upd("m", bst_fwde, s["start"] + 1)
            upd("st", bst_fwde, jnp.full_like(st, S_FWDE_M))

            # ================= S_BACK =================
            bck_ok = is_bck & rd_is_base & (s["k"] >= 0) & (ocsb >= s["min_intv"])
            bck_stop = is_bck & ~(rd_is_base & (s["k"] >= 0) & (ocsb >= s["min_intv"]))
            upd("ik0", bck_ok, oc0b)
            upd("ik1", bck_ok, oc1b)
            upd("iks", bck_ok, ocsb)
            upd("ikst", bck_ok, s["k"])
            # iken unchanged (= curr[ic].end); merged bk write (one masked
            # write for both the BSTART seed row and BACK's append)
            slot_b = jnp.minimum(s["back_n"], LB - 1)
            bk_mask = bst_back | bck_ok
            bk_row = jnp.where(bst_back, zb, slot_b)
            n["bk0"] = _write_row(n["bk0"], bk_row, jnp.where(bst_back, c_x0, oc0b), bk_mask)
            n["bk1"] = _write_row(n["bk1"], bk_row, jnp.where(bst_back, c_x1, oc1b), bk_mask)
            n["bk2"] = _write_row(n["bk2"], bk_row, jnp.where(bst_back, c_s, ocsb), bk_mask)
            n["bk3"] = _write_row(n["bk3"], bk_row, jnp.where(bst_back, s["x"], s["k"]), bk_mask)
            n["bk4"] = _write_row(n["bk4"], bk_row, jnp.where(bst_back, c_end, s["iken"]), bk_mask)
            upd("back_n", bck_ok, s["back_n"] + 1)
            n["bust"] = n["bust"] | (bck_ok & (s["back_n"] >= LB))
            upd("k", bck_ok, s["k"] - 1)
            # back-chain epilogue folded into the stop step (the old
            # S_BACK_POST park step — round 4): start = curr[ic].end
            # (== iken), stop = curr[ic+1].end or ln (c_* reads run at
            # ic+1 during S_BACK), temp = ik, ic++, into the skip scan
            upd("start", bck_stop, s["iken"])
            upd("stop", bck_stop, jnp.where(s["ic"] < s["curr_n"] - 1, c_end, lnc))
            t_len = s["t4"] - s["t3"]
            bpo_push = bck_stop & (s["ic"] > 0) & (s["ikst"] > s["t3"]) & (t_len >= MIN_SEED_LEN)
            # (mem pushes from all states merge into one masked write below)
            for tk_, ik_ in (("t0", "ik0"), ("t1", "ik1"), ("t2", "iks"), ("t3", "ikst"), ("t4", "iken")):
                upd(tk_, bck_stop, s[ik_])
            upd("ic", bck_stop, s["ic"] + 1)
            upd("skip_first", bck_stop, jnp.ones(B, bool))
            upd("st", bck_stop, jnp.full_like(st, S_SKIP))

            # ================= S_FWDE_M =================
            fem_fail = is_fem & (ocsf < s["min_intv"])
            fem_ok = is_fem & ~(ocsf < s["min_intv"])
            at_stop = fem_ok & (s["m"] == s["stop"])
            # inner-loop failure: reload back[k-1] and continue (b_* reads
            # run at k-1 during S_FWDE_M), or k exhausted -> interval
            # epilogue — both directions of the old S_FWDE_K park step
            fail_go = fem_fail & (s["k"] - 1 >= 0)
            fail_done = fem_fail & (s["k"] - 1 < 0)
            upd("k", fail_go, s["k"] - 1)
            upd("ik0", fail_go, b_x0)
            upd("ik1", fail_go, b_x1)
            upd("iks", fail_go, b_s)
            upd("ikst", fail_go, b_st)
            upd("iken", fail_go, b_en)
            upd("m", fail_go, s["start"] + 1)
            upd("ic", fail_done, s["ic"] + 1)
            upd("skip_first", fail_done, jnp.ones(B, bool))
            upd("st", fail_done, jnp.full_like(st, S_SKIP))
            # successful extension
            upd("ik0", fem_ok, oc0f)
            upd("ik1", fem_ok, oc1f)
            upd("iks", fem_ok, ocsf)
            upd("m", fem_ok & ~at_stop, s["m"] + 1)
            # reached stop: finalize interval, temp/mem logic, next interval
            nw_st = s["x"] - s["k"]
            upd("ikst", at_stop, nw_st)
            upd("iken", at_stop, s["stop"])
            fem_push = at_stop & (nw_st > s["t3"]) & (t_len >= MIN_SEED_LEN)
            upd("t0", at_stop, oc0f)
            upd("t1", at_stop, oc1f)
            upd("t2", at_stop, ocsf)
            upd("t3", at_stop, nw_st)
            upd("t4", at_stop, s["stop"])
            upd("ic", at_stop, s["ic"] + 1)
            upd("skip_first", at_stop, jnp.ones(B, bool))
            upd("st", at_stop, jnp.full_like(st, S_SKIP))

            # ================= S_SKIP =================
            # (masks computed above; exits run the BSTART block inline)
            # final push of the trailing temp, then exit to the pass driver
            fin_push = skp_done & (s["t4"] - s["t3"] >= MIN_SEED_LEN)
            back_p1 = skp_done & (s["mode"] == 1)
            back_p2 = skp_done & (s["mode"] == 2)
            upd("x", back_p1, s["ret"])
            upd("st", back_p1, jnp.full_like(st, S_P1_NEXTX))
            upd("st", back_p2, jnp.full_like(st, S_P2_NEXT))
            # skip-ahead: stop updates on continuation iterations only
            upd("stop", skp_live & ~s["skip_first"], c_end)
            upd("ic", skp_more, s["ic"] + 1)
            upd("skip_first", skp_more, jnp.zeros(B, bool))

            if include_p3:
                # ---- pass-3 states live in the same body (multi-read) ----
                p3_push = _p3_updates(
                    s, upd, st, rd_is_base, oc0f, oc1f, ocsf, ix0, ix1,
                    isz, lnc
                )

            # ---- merged mem push ------------------------------------------
            # every push site is mutually exclusive (one state per lane per
            # iteration), so they collapse into ONE masked write over the
            # (MAX_OUT, B) buffers with the values chosen by (B,) selects
            push_t = bpo_push | fem_push | fin_push  # all push the temp regs
            if include_p3:
                # pass 3 pushes the fresh extension, not the temp regs
                w0 = jnp.where(p3_push, oc0f, s["t0"])
                w1 = jnp.where(p3_push, oc1f, s["t1"])
                w2 = jnp.where(p3_push, ocsf, s["t2"])
                w3 = jnp.where(p3_push, s["x"], s["t3"])
                w4 = jnp.where(p3_push, s["i"] + 1, s["t4"])
                push_mem(push_t | p3_push, w0, w1, w2, w3, w4)
            else:
                push_mem(push_t, s["t0"], s["t1"], s["t2"], s["t3"], s["t4"])

            if Q > 1:
                # ---- read switch: pass-3 exhausted -> next read ----------
                # _p3_updates parked the lane at S_DONE; lanes with reads
                # left override to a fresh S_P1_NEXTX with registers reset
                # (pads only ever trail, so a zero next_len means the lane
                # is truly finished).  The read boundary (absolute mem_n)
                # and per-read bust flag land in bnd/bq at row q; the
                # engine slices read (q, b)'s intervals from the lane's
                # column by these boundaries.
                fin = (st == S_P3_NEXTX) & (s["x"] >= lnc)  # p3_done
                next_len = _read_row(lens_q, s["q"] + 1)
                switch = fin & (s["q"] < Q - 1) & (next_len > 0)
                n["bnd"] = _write_row(n["bnd"], s["q"], s["mem_n"], fin)
                n["bq"] = _write_row(
                    n["bq"], s["q"], s["bust"], fin
                ).astype(bool)
                upd("st", switch, jnp.full_like(st, S_P1_NEXTX))
                for key in ("x", "i", "ic", "k", "m", "p2_k", "p2_old_n",
                            "curr_n", "back_n", "start", "stop", "ret",
                            "ik0", "ik1", "iks", "ikst", "iken",
                            "t0", "t1", "t2", "t3", "t4"):
                    upd(key, switch, zb)
                upd("mode", switch, zb + 1)
                upd("min_intv", switch, zb + 1)
                upd("skip_first", switch, zb > 0)
                upd("bust", switch, zb > 0)
                upd("mem_base", switch, s["mem_n"])
                upd("q", switch, s["q"] + 1)
                upd("ln", switch, next_len)

            return n

        return body

    def body3(s):
        """Pass 3 (LAST-like scan): no curr/back machinery at all — the
        carry is just the mem buffers, the ik registers, and the scan
        positions, so each iteration touches ~1/3 the state of a pass-1
        step."""
        st = s["st"]
        is_p3x = st == S_P3_NEXTX
        is_p3e = st == S_P3_EXT

        pos = jnp.where(is_p3e, s["i"], s["x"])
        rd = seq_at(pos)
        rd_is_base = rd < 4

        o0, o1, osz = _extend_batch(
            idx, s["ik0"], s["ik1"], s["iks"], is_p3x & False
        )
        c_fwd = 3 - rd
        oc0f, oc1f, ocsf = _pick(c_fwd, o0), _pick(c_fwd, o1), _pick(c_fwd, osz)

        n = dict(s)
        n["iters"] = s["iters"] + 1
        _hist_add(n, st)

        def upd(key, mask, val):
            n[key] = jnp.where(mask, val, n[key])

        ix0 = jnp.take(l2, jnp.clip(rd, 0, 3)) + 1
        ix1 = jnp.take(l2, jnp.clip(3 - rd, 0, 3)) + 1
        isz = jnp.take(l2, jnp.clip(rd, 0, 3) + 1) - jnp.take(
            l2, jnp.clip(rd, 0, 3)
        )

        push = _p3_updates(
            s, upd, st, rd_is_base, oc0f, oc1f, ocsf, ix0, ix1, isz, ln
        )

        # mem push (pass 3 pushes the fresh extension, not the temp regs)
        cnt = n["mem_n"]
        slot = jnp.minimum(cnt, MM - 1)
        w = push & (cnt < MM)
        n["bust"] = n["bust"] | (push & (cnt >= MM))
        n["mm0"] = _write_row(n["mm0"], slot, oc0f, w)
        n["mm1"] = _write_row(n["mm1"], slot, oc1f, w)
        n["mm2"] = _write_row(n["mm2"], slot, ocsf, w)
        n["mm3"] = _write_row(n["mm3"], slot, s["x"], w)
        n["mm4"] = _write_row(n["mm4"], slot, s["i"] + 1, w)
        n["mem_n"] = jnp.where(push, cnt + 1, cnt)
        return n

    # unrolled bodies: the (rows, B) buffers live in the while carry, i.e.
    # HBM — each iteration pays a full read+write.  Running UNROLL machine
    # steps per iteration amortizes that carry traffic; the masked updates
    # between sub-steps fuse on chip.  DONE lanes no-op, so overshooting
    # by < UNROLL steps is harmless.  On CPU (the test ladder) the carry
    # never leaves cache and the unroll only multiplies XLA compile time
    # of the already-large body 4-8x, so it stays 1 there.
    import os

    on_cpu = jax.devices()[0].platform == "cpu"
    # 4 was chosen on the engine's first platform, where 4/8/16 measured
    # flat; kept until a sweep on the GPU (chip_smoke.py prints the
    # us_per_machine_step this setting gives).  The env knob is for A/Bs
    UNROLL = 1 if on_cpu else int(os.environ.get("SMEM_UNROLL", "4"))
    UNROLL_P3 = 1 if on_cpu else 2 * UNROLL  # pass-3 body is ~1/3 the state

    def unrolled(body, k=UNROLL):
        def body_u(s):
            for _ in range(k):
                s = body(s)
            return s
        return body_u

    # ---- multi-read mode: ONE unified loop, all passes x Q reads ------
    if Q > 1:
        body1 = make_body12(include_p3=True)

        def flush_hot(s):
            """Bulk-copy hot pushes into the main planes at rows
            [mem_n - hn, mem_n).  One full-plane masked write per HOT
            machine steps; the HOT-way select chain fuses into the same
            elementwise pass."""
            n = dict(s)
            io = jax.lax.broadcasted_iota(I32, (MM, B), 0)
            rel = io - (s["mem_n"] - s["hn"])[None, :]
            m = (rel >= 0) & (rel < s["hn"][None, :])
            for mk, hk in (("mm0", "h0"), ("mm1", "h1"), ("mm2", "h2"),
                           ("mm3", "h3"), ("mm4", "h4")):
                vals = jnp.zeros((MM, B), s[mk].dtype)
                for j in range(HOT):
                    vals = jnp.where(
                        rel == j, s[hk][j][None, :].astype(s[mk].dtype),
                        vals,
                    )
                n[mk] = jnp.where(m, vals, n[mk])
            n["hn"] = s["hn"] * 0
            return n

        def body_multi(s):
            # HOT machine steps (hot buffer can take one push per lane
            # per step), then one flush — DONE lanes no-op, so the
            # fixed HOT-deep unroll overshoots harmlessly
            for _ in range(HOT):
                s = body1(s)
            return flush_hot(s)

        f = jax.lax.while_loop(cond, body_multi, init)
        # lanes still live at the safety cap: every read from the lane's
        # current q on is unfinished -> flag for host rerun
        unf = (f["st"] != S_DONE) | f["bust"]
        ioq = jax.lax.broadcasted_iota(I32, (Q, B), 0)
        bq = f["bq"] | (unf[None, :] & (ioq >= f["q"][None, :]))
        out = (
            (f["mm0"], f["mm1"], f["mm2"], f["mm3"], f["mm4"]),
            f["mem_n"], f["bnd"], bq, f["iters"],
        )
        if STATE_HIST:
            out = out + (f["hist"], f["live_t"])
        return out

    # ---- passes 1 + 2 (combined loop; lanes flow p1 -> p2) ------------
    f2 = jax.lax.while_loop(cond, unrolled(make_body12()), init)
    unf2 = f2["st"] != S_DONE  # hit the safety cap mid-pass

    # ---- phase 3: LAST-like scan (reduced carry) ----------------------
    init3 = dict(
        st=jnp.where((ln > 0) & ~unf2, jnp.int32(S_P3_NEXTX), jnp.int32(S_DONE)),
        x=zb, i=zb, ik0=zb, ik1=zb, iks=zb,
        mem_n=f2["mem_n"], bust=f2["bust"],
        mm0=f2["mm0"], mm1=f2["mm1"], mm2=f2["mm2"],
        mm3=f2["mm3"], mm4=f2["mm4"],
        iters=f2["iters"],
    )
    if STATE_HIST:
        init3["hist"] = f2["hist"]
        init3["live_t"] = f2["live_t"]
    f3 = jax.lax.while_loop(cond, unrolled(body3, UNROLL_P3), init3)

    # lanes still running when the safety cap fires, or whose curr/back
    # chains or output pushes outgrew the capped buffers, are reported as
    # "unfinished" by forcing their count past the overflow cap — the
    # engine reruns them on the host (graceful-degradation contract)
    unfinished = (f3["st"] != S_DONE) | f3["bust"] | unf2
    mem_n = jnp.where(unfinished, jnp.int32(MAX_OUT + 1), f3["mem_n"])
    out = (
        (f3["mm0"], f3["mm1"], f3["mm2"], f3["mm3"], f3["mm4"]),
        mem_n,
        f3["iters"],
    )
    if STATE_HIST:
        out = out + (f3["hist"], f3["live_t"])
    return out


_collect_jit = jax.jit(
    smem_collect_machine, static_argnames=("max_iters", "params")
)

# multi-read entry: Q reads per lane, unified body (see the docstring)
_collect_multi_jit = jax.jit(
    smem_collect_machine,
    static_argnames=("max_iters", "params", "reads_per_lane"),
)


@functools.partial(jax.jit, static_argnames=("tot",))
def smem_flat_gather(mem, starts, cols, counts, tot: int):
    """Ragged device-side fetch of multi-read outputs: exactly the live
    intervals, flattened read-major, instead of a dense
    (used, n) rectangle whose row count is the bucketed MAX per-read
    count (mean ~6.2 vs max-bucket 12 at Q=8/101 bp — the rectangle
    shipped ~2x the live bytes).  tot: static flat slot count (>= sum(counts),
    bucketed by the engine to bound jit shapes); pad slots replicate
    the last read's tail and are dropped host-side.

    Returns (f32 (3, tot) int32 [x0,x1,s], f16 (2, tot) int16
    [start,end]); read r's intervals occupy flat slots
    [cumsum(counts)[r-1], cumsum(counts)[r])."""
    n = starts.shape[0]
    roff = jnp.cumsum(counts) - counts  # first flat slot of read r
    rid = jnp.repeat(
        jnp.arange(n, dtype=I32), counts, total_repeat_length=tot
    )
    jr = jnp.arange(tot, dtype=I32) - jnp.take(roff, rid)
    row = jnp.clip(jnp.take(starts, rid) + jr, 0, mem[0].shape[0] - 1)
    fi = row * mem[0].shape[1] + jnp.take(cols, rid)

    def g(m):
        return jnp.take(m.reshape(-1), fi)

    f32 = jnp.stack([g(mem[0]), g(mem[1]), g(mem[2])]).astype(I32)
    f16 = jnp.stack([g(mem[3]), g(mem[4])]).astype(jnp.int16)
    return f32, f16


_IV_KEYS = ("x0", "x1", "s", "start", "end")


def intervals_to_dicts(mem, nn, n_lanes):
    """(5, rows, B) int array + per-lane counts -> per-lane interval-dict
    lists.  One vectorized transpose+tolist instead of 5 numpy scalar
    reads per interval (~4x less host time per read; the conversion was
    ~30 us/read and dominated engine e2e at genome scale)."""
    if mem.size == 0:
        return [[] for _ in range(n_lanes)]
    rows_list = mem.transpose(2, 1, 0).tolist()  # (B, rows, 5) python ints
    return [
        [dict(zip(_IV_KEYS, row)) for row in rows_list[k][: int(nn[k])]]
        for k in range(n_lanes)
    ]


def smem_batch_machine(
    fm_or_idx, reads: List[np.ndarray], seq_len: int = 256, mesh=None,
    params: SmemParams = DEFAULT_SMEM_PARAMS,
):
    """Host wrapper: list of nt4 reads -> (per-read interval dicts,
    overflow flags, machine iteration count).  Overflow (n >
    max_intv_alloc) -> host rerun, smem/main.cpp:158-164.  With a mesh,
    lanes shard over its "data" axis (index replicated per device)."""
    MAX_OUT = params.max_intv_alloc
    idx = (
        device_index_fused(fm_or_idx)
        if isinstance(fm_or_idx, FMIndex)
        else fm_or_idx
    )
    n_in = len(reads)
    bsz = n_in
    dsz = int(mesh.shape["data"]) if mesh is not None else 1
    if bsz % dsz:
        bsz += dsz - bsz % dsz  # inert zero-length lanes
    seq_tm = np.full((seq_len, bsz), 4, np.uint8)
    lens = np.zeros(bsz, np.int32)
    for k, r in enumerate(reads):
        if len(r) > seq_len:
            raise ValueError("read exceeds seq bucket")
        seq_tm[: len(r), k] = r
        lens[k] = len(r)
    if mesh is not None:
        from acc_genomics_tpu.parallel.sharded import shard_lanes
        from acc_genomics_tpu.parallel.sharded_kernels import smem_collect_dp

        mem, mem_n, iters = smem_collect_dp(
            mesh, idx, *shard_lanes(mesh, (seq_tm, lens)), params=params
        )
        iters = np.max(np.asarray(iters))
    else:
        mem, mem_n, iters = _collect_jit(
            idx, jnp.asarray(seq_tm), jnp.asarray(lens), params=params
        )
    # two D2H transfers total: counts first (to size the prefix), then
    # the five interval fields stacked into ONE array
    mem_n, iters = jax.device_get((mem_n, jnp.asarray(iters)))
    used = int(min(MAX_OUT, mem_n.max(initial=0)))
    mem = np.asarray(jnp.stack([m[:used].astype(jnp.int32) for m in mem]))
    overflow = (mem_n > MAX_OUT)[:n_in]
    rows = mem.shape[1]  # may be < used: bust lanes force mem_n past cap
    out = intervals_to_dicts(mem, np.minimum(mem_n, rows), n_in)
    return out, overflow, int(iters)

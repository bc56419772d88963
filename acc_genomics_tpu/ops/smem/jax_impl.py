"""Batched on-device SMEM collection.

Device redesign of the reference's 7-stage FPGA dataflow (smem/device/
smem.cpp: input_dup -> fe/afe -> be -> lfe -> lbe -> output, arbitrated
by a bwt_manager DRAM engine): on the device the "stages" collapse into one
vmapped program — each read is a lane, every BWT probe is a 32-byte
gather (occ checkpoint + 2-bit packed words, popcount via
lax.population_count), and the reference's 16-read address/data
ping-pong for latency hiding becomes XLA's batched gather over the full
lane dimension.

Control flow is a faithful lax translation of the 3-pass
mem_collect_intv pipeline (ops/smem/reference.py is the NumPy oracle):
nested lax.while_loops per read, vmapped over the batch; interval
buffers are fixed-size (curr/back: seq length; mem: MAX_INTV_ALLOC).
Reads whose interval count overflows the output buffer keep counting
(n > cap) so the engine can flag them for host rerun — the reference's
overflow contract (smem/main.cpp:158-164).

Index integers are int32 (text up to 2^31 bases); the index builder
also keeps int64 for the host oracle.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.ops.smem.index import FMIndex, OCC_INTERVAL
from acc_genomics_tpu.ops.smem.reference import (
    MAX_MEM_INTV,
    MIN_SEED_LEN,
    SPLIT_LEN,
    SPLIT_WIDTH,
)

I32 = jnp.int32
MAX_OUT = 256  # MAX_INTV_ALLOC


def device_index(fm: FMIndex):
    """Device arrays for the index (int32 rank space)."""
    assert fm.seq_len < 2**31
    return dict(
        ckpt=jnp.asarray(fm.occ_ckpt.astype(np.int32)),
        words=jnp.asarray(fm.bwt_packed),
        l2=jnp.asarray(fm.L2.astype(np.int32)),
        primary=jnp.asarray(np.int32(fm.primary)),
    )


def _occ4(idx, k):
    """(4,) counts of each base among the first k+1 BWT rows; k scalar."""
    valid = k >= 0
    kk = k - (k >= idx["primary"]).astype(I32)
    kk = jnp.maximum(kk, 0)
    blk = kk // OCC_INTERVAL
    off = kk % OCC_INTERVAL
    cnt = idx["ckpt"][blk]
    w = idx["words"][blk]  # (4,) uint32, 16 bases each
    m_idx = jnp.arange(4, dtype=I32)
    keep = jnp.clip(off + 1 - 16 * m_idx, 0, 16)
    # fields j < keep live at high bits: mask = 0xFFFFFFFF << (32 - 2*keep),
    # computed x64-free (shift clamped to 31; keep==0 handled by the where)
    sh = jnp.clip(32 - 2 * keep, 0, 31).astype(jnp.uint32)
    mask = jnp.where(
        keep == 0, jnp.uint32(0), jnp.uint32(0xFFFFFFFF) << sh
    )
    outs = []
    for c in range(4):
        pat = jnp.uint32(0x55555555 * c)
        nx = ~(w ^ pat)
        y = nx & (nx >> 1) & jnp.uint32(0x55555555)
        cc = jax.lax.population_count(y & mask).sum().astype(I32)
        outs.append(cnt[c] + cc)
    return jnp.where(valid, jnp.stack(outs), 0)


def _extend(idx, x0, x1, s, is_back: bool):
    """ok intervals for all 4 bases: returns (o0, o1, os) each (4,)."""
    xf = x0 if is_back else x1
    xo = x1 if is_back else x0
    tk = _occ4(idx, xf - 1)
    tl = _occ4(idx, xf - 1 + s)
    cnt_coord = idx["l2"][:4] + 1 + tk
    oks = tl - tk
    span = ((xf <= idx["primary"]) & (xf + s - 1 >= idx["primary"])).astype(I32)
    suff_incl = jnp.cumsum(oks[::-1])[::-1]
    oth = xo + span + (suff_incl - oks)
    # the counted coordinate is x[1-is_back]: x0 for backward, x1 for forward
    if is_back:
        return cnt_coord, oth, oks
    return oth, cnt_coord, oks


def _set_intv(idx, c):
    x0 = idx["l2"][c] + 1
    x1 = idx["l2"][3 - c] + 1
    s = idx["l2"][c + 1] - idx["l2"][c]
    return x0, x1, s


def _push(bufs, n, vals):
    """Append vals to parallel buffers at slot n (clamped); returns n+1."""
    cap = bufs[0].shape[0]
    slot = jnp.minimum(n, cap - 1)
    write = n < cap
    new = []
    for b, v in zip(bufs, vals):
        new.append(jnp.where(write, b.at[slot].set(v), b))
    return tuple(new), n + 1


def _smem1a(idx, seq, ln, x, min_intv, mem, mem_n):
    """lax translation of smem1a_fwdback for one read.

    mem: tuple of 5 (MAX_OUT,) buffers (x0, x1, s, start, end).
    Returns (ret, mem, mem_n).
    """
    L = seq.shape[0]
    min_intv = jnp.maximum(min_intv, 1)

    curr = tuple(jnp.zeros(L + 1, I32) for _ in range(4))  # x0 x1 s end
    ix0, ix1, isz = _set_intv(idx, seq[x])

    # ---- forward pass ----
    def fwd_cond(st):
        i, done = st[0], st[5]
        return (i < ln) & jnp.logical_not(done)

    def fwd_body(st):
        i, ik, curr, curr_n, pushed_brk, done = st
        kx0, kx1, ks, kend = ik
        qi = seq[i]
        is_base = qi < 4
        c = 3 - qi
        o0, o1, osz = _extend(idx, kx0, kx1, ks, False)
        oc0, oc1, ocs = o0[c], o1[c], osz[c]
        changed = ocs != ks
        push_now = jnp.logical_not(is_base) | (is_base & changed)
        curr2, curr_n2 = _push(curr, curr_n, (kx0, kx1, ks, kend))
        curr = tuple(jnp.where(push_now, a, b) for a, b in zip(curr2, curr))
        curr_n = jnp.where(push_now, curr_n2, curr_n)
        stop = jnp.logical_not(is_base) | (is_base & changed & (ocs < min_intv))
        adv = is_base & jnp.logical_not(stop)
        ik = (
            jnp.where(adv, oc0, kx0),
            jnp.where(adv, oc1, kx1),
            jnp.where(adv, ocs, ks),
            jnp.where(adv, i + 1, kend),
        )
        return (i + 1, ik, curr, curr_n, pushed_brk, stop)

    st0 = (
        x + 1,
        (ix0, ix1, isz, x + 1),
        curr,
        jnp.asarray(0, I32),
        jnp.asarray(False),
        jnp.asarray(False),
    )
    i_f, ik_f, curr, curr_n, _, done_f = jax.lax.while_loop(fwd_cond, fwd_body, st0)
    # natural exit (no break): push the final interval
    curr2, curr_n2 = _push(curr, curr_n, ik_f)
    nat = jnp.logical_not(done_f)
    curr = tuple(jnp.where(nat, a, b) for a, b in zip(curr2, curr))
    curr_n = jnp.where(nat, curr_n2, curr_n)
    ret = curr[3][jnp.minimum(curr_n - 1, L)]

    # ---- backward passes ----
    back = tuple(jnp.zeros(L + 1, I32) for _ in range(5))  # x0 x1 s start end

    def b_cond(st):
        return st[0] < curr_n

    def b_body(st):
        (ic, start, stop, back, back_n, temp, mem, mem_n) = st
        cx0 = curr[0][ic]
        cx1 = curr[1][ic]
        cs = curr[2][ic]
        cend = curr[3][ic]
        use_back = (back_n == 0) | (stop - start >= 3)

        def backenlarge(args):
            (start, stop, back, back_n, temp, mem, mem_n) = args
            back0 = tuple(jnp.zeros_like(b) for b in back)
            back0, bn = _push(back0, jnp.asarray(0, I32), (cx0, cx1, cs, x, cend))

            def k_cond(s2):
                return jnp.logical_not(s2[3])

            def k_body(s2):
                k, ik, (back, bn), _d = s2
                kx0, kx1, ks, kst, ken = ik
                qk = jnp.where(k < 0, 4, seq[jnp.maximum(k, 0)])
                c = jnp.where(qk < 4, qk, -1)
                valid = (k >= -1) & (c >= 0)
                o0, o1, osz = _extend(idx, kx0, kx1, ks, True)
                cc = jnp.maximum(c, 0)
                ok_small = osz[cc] < min_intv
                stop_now = jnp.logical_not(valid) | ok_small
                adv = jnp.logical_not(stop_now)
                ik2 = (
                    jnp.where(adv, o0[cc], kx0),
                    jnp.where(adv, o1[cc], kx1),
                    jnp.where(adv, osz[cc], ks),
                    jnp.where(adv, k, kst),
                    jnp.where(adv, cend, ken),
                )
                back2, bn2 = _push(back, bn, ik2)
                back = tuple(jnp.where(adv, a, b) for a, b in zip(back2, back))
                bn = jnp.where(adv, bn2, bn)
                return (k - 1, ik2, (back, bn), stop_now)

            ik0 = (cx0, cx1, cs, x, cend)
            _, ik_b, (back, bn), _ = jax.lax.while_loop(
                k_cond, k_body, (x - 1, ik0, (back0, bn), jnp.asarray(False))
            )
            start2 = cend
            stop2 = jnp.where(ic == curr_n - 1, ln, curr[3][jnp.minimum(ic + 1, L)])
            # temp / mem push logic
            t_len = temp[4] - temp[3]
            push = (ic > 0) & (ik_b[3] > temp[3]) & (t_len >= MIN_SEED_LEN)
            mem2, mem_n2 = _push(mem, mem_n, temp)
            mem = tuple(jnp.where(push, a, b) for a, b in zip(mem2, mem))
            mem_n = jnp.where(push, mem_n2, mem_n)
            return (start2, stop2, back, bn, ik_b, mem, mem_n)

        def forwardenlarge(args):
            (start, stop_in, back, back_n, temp, mem, mem_n) = args
            stop = cend

            def k_cond(s2):
                k, _ik, isbrk, done = s2[0], s2[1], s2[2], s2[3]
                return (k >= 0) & jnp.logical_not(done)

            def k_body(s2):
                k, _ik_prev, _brk_prev, _done, temp2, mem2, mem_n2 = s2
                ik = (back[0][k], back[1][k], back[2][k], back[3][k], back[4][k])

                def m_cond(s3):
                    m, _ik, done, _brk = s3
                    return (m <= stop) & jnp.logical_not(done)

                def m_body(s3):
                    m, ik, done, brk = s3
                    kx0, kx1, ks, kst, ken = ik
                    c = 3 - seq[jnp.maximum(m - 1, 0)]
                    o0, o1, osz = _extend(idx, kx0, kx1, ks, False)
                    small = osz[c] < min_intv
                    adv = jnp.logical_not(small)
                    at_stop = adv & (m == stop)
                    ik2 = (
                        jnp.where(adv, o0[c], kx0),
                        jnp.where(adv, o1[c], kx1),
                        jnp.where(adv, osz[c], ks),
                        jnp.where(at_stop, x - k, kst),
                        jnp.where(at_stop, cend, ken),
                    )
                    return (m + 1, ik2, small, brk | at_stop)

                m0 = start + 1
                _, ik_m, _, isbrk = jax.lax.while_loop(
                    m_cond, m_body, (m0, ik, jnp.asarray(False), jnp.asarray(False))
                )
                # on success: temp/mem logic, stop outer loop
                t_len = temp2[4] - temp2[3]
                push = isbrk & ((x - k) > temp2[3]) & (t_len >= MIN_SEED_LEN)
                memp, mem_np = _push(mem2, mem_n2, temp2)
                mem3 = tuple(jnp.where(push, a, b) for a, b in zip(memp, mem2))
                mem_n3 = jnp.where(push, mem_np, mem_n2)
                temp3 = tuple(jnp.where(isbrk, a, b) for a, b in zip(ik_m, temp2))
                return (k - 1, ik_m, isbrk, isbrk, temp3, mem3, mem_n3)

            ik_dummy = (cx0, cx1, cs, x, cend)
            st2 = (
                back_n - 1, ik_dummy, jnp.asarray(False), jnp.asarray(False),
                temp, mem, mem_n,
            )
            _, _, _, _, temp, mem, mem_n = jax.lax.while_loop(k_cond, k_body, st2)
            return (start, stop, back, back_n, temp, mem, mem_n)

        args = (start, stop, back, back_n, temp, mem, mem_n)
        (start, stop, back, back_n, temp, mem, mem_n) = jax.lax.cond(
            use_back, backenlarge, forwardenlarge, args
        )
        ic = ic + 1

        # skip-ahead loop over impossible intervals
        def skip_cond(s2):
            ic2, stop2 = s2
            nxt_end = curr[3][jnp.minimum(ic2, L)]
            max_len = temp[3] + jnp.where(ic2 < curr_n, nxt_end, stop2)
            return (max_len < MIN_SEED_LEN) & (ic2 < curr_n)

        def skip_body(s2):
            ic2, stop2 = s2
            ic2 = ic2 + 1
            stop2 = jnp.where(ic2 < curr_n, curr[3][jnp.minimum(ic2, L)], stop2)
            return (ic2, stop2)

        # the reference evaluates max_len with curr[ic].end while ic < n,
        # else with the running stop
        def skip_wrap(s2):
            ic2, stop2 = s2
            return jax.lax.while_loop(skip_cond, skip_body, (ic2, stop2))

        ic, stop = jax.lax.cond(
            ic < curr_n, skip_wrap, lambda s2: s2, (ic, stop)
        )
        return (ic, start, stop, back, back_n, temp, mem, mem_n)

    temp0 = (
        jnp.asarray(0, I32), jnp.asarray(0, I32), jnp.asarray(0, I32),
        jnp.asarray(0, I32), jnp.asarray(0, I32),
    )
    st0 = (
        jnp.asarray(0, I32), x, x, back, jnp.asarray(0, I32), temp0, mem, mem_n,
    )
    (_, _, _, _, _, temp, mem, mem_n) = jax.lax.while_loop(b_cond, b_body, st0)
    # final push of the trailing temp
    t_len = temp[4] - temp[3]
    push = (curr_n > 0) & (t_len >= MIN_SEED_LEN)
    mem2, mem_n2 = _push(mem, mem_n, temp)
    mem = tuple(jnp.where(push, a, b) for a, b in zip(mem2, mem))
    mem_n = jnp.where(push, mem_n2, mem_n)
    return ret, mem, mem_n


def _seed_strategy1(idx, seq, ln, x):
    """(next_x, interval(5,), found) — bwt_seed_strategy1."""

    def cond(st):
        i, _ik, _iv, done, found = st
        return jnp.logical_not(done)

    def body(st):
        i, ik, iv, done, found = st
        in_range = i < ln
        qi = jnp.where(in_range, seq[jnp.minimum(i, seq.shape[0] - 1)], 4)
        is_base = qi < 4
        c = 3 - qi
        o0, o1, osz = _extend(idx, ik[0], ik[1], ik[2], False)
        cc = jnp.maximum(c, 0)
        hit = in_range & is_base & (osz[cc] < MAX_MEM_INTV) & ((i - x) >= MIN_SEED_LEN)
        iv2 = (o0[cc], o1[cc], osz[cc], x, i + 1)
        iv = tuple(jnp.where(hit, a, b) for a, b in zip(iv2, iv))
        stop = jnp.logical_not(in_range) | jnp.logical_not(is_base) | hit
        adv = in_range & is_base & jnp.logical_not(hit)
        ik = (
            jnp.where(adv, o0[cc], ik[0]),
            jnp.where(adv, o1[cc], ik[1]),
            jnp.where(adv, osz[cc], ik[2]),
        )
        nxt = jnp.where(jnp.logical_not(in_range), ln, i + 1)
        return (jnp.where(stop, nxt, i + 1), ik, iv, stop, found | hit)

    ix0, ix1, isz = _set_intv(idx, seq[x])
    iv0 = tuple(jnp.asarray(0, I32) for _ in range(5))
    st = (x + 1, (ix0, ix1, isz), iv0, jnp.asarray(False), jnp.asarray(False))
    nxt, _, iv, _, found = jax.lax.while_loop(cond, body, st)
    return nxt, iv, found


def _collect_one(idx, seq, ln):
    """Full 3-pass mem_collect for one read."""
    mem = tuple(jnp.zeros(MAX_OUT, I32) for _ in range(5))
    mem_n = jnp.asarray(0, I32)

    # pass 1
    def p1_cond(st):
        return st[0] < ln

    def p1_body(st):
        x, mem, mem_n = st
        is_base = seq[x] < 4

        def run(args):
            mem, mem_n = args
            nxt, mem, mem_n = _smem1a(idx, seq, ln, x, jnp.asarray(1, I32), mem, mem_n)
            # progress guard: under vmap both cond branches execute with
            # whatever x inactive lanes hold; ret is then garbage and must
            # still advance or the batched while_loop never terminates
            return jnp.maximum(nxt, x + 1), mem, mem_n

        def skip(args):
            mem, mem_n = args
            return x + 1, mem, mem_n

        nxt, mem, mem_n = jax.lax.cond(is_base, run, skip, (mem, mem_n))
        return (nxt, mem, mem_n)

    _, mem, mem_n = jax.lax.while_loop(
        p1_cond, p1_body, (jnp.asarray(0, I32), mem, mem_n)
    )

    # pass 2: re-seed long low-occ SMEMs from midpoints
    old_n = mem_n

    def p2_cond(st):
        return st[0] < old_n

    def p2_body(st):
        k, mem, mem_n = st
        kk = jnp.minimum(k, MAX_OUT - 1)
        start = mem[3][kk]
        end = mem[4][kk]
        s = mem[2][kk]
        do = ((end - start) >= SPLIT_LEN) & (s <= SPLIT_WIDTH) & (k < MAX_OUT)
        mid = (start + end) >> 1

        def run(args):
            mem, mem_n = args
            ok = seq[mid] < 4

            def go(a2):
                mem, mem_n = a2
                _, mem, mem_n = _smem1a(idx, seq, ln, mid, s + 1, mem, mem_n)
                return mem, mem_n

            return jax.lax.cond(ok, go, lambda a2: a2, (mem, mem_n))

        mem, mem_n = jax.lax.cond(do, run, lambda a: a, (mem, mem_n))
        return (k + 1, mem, mem_n)

    _, mem, mem_n = jax.lax.while_loop(
        p2_cond, p2_body, (jnp.asarray(0, I32), mem, mem_n)
    )

    # pass 3: LAST-like
    def p3_cond(st):
        return st[0] < ln

    def p3_body(st):
        x, mem, mem_n = st
        is_base = seq[x] < 4

        def run(args):
            mem, mem_n = args
            nxt, iv, found = _seed_strategy1(idx, seq, ln, x)
            push = found & (iv[2] > 0)
            mem2, mem_n2 = _push(mem, mem_n, iv)
            mem = tuple(jnp.where(push, a, b) for a, b in zip(mem2, mem))
            mem_n = jnp.where(push, mem_n2, mem_n)
            return nxt, mem, mem_n

        def skip(args):
            mem, mem_n = args
            return x + 1, mem, mem_n

        nxt, mem, mem_n = jax.lax.cond(is_base, run, skip, (mem, mem_n))
        return (nxt, mem, mem_n)

    _, mem, mem_n = jax.lax.while_loop(
        p3_cond, p3_body, (jnp.asarray(0, I32), mem, mem_n)
    )
    return mem, mem_n


@jax.jit
def smem_collect_batch(idx, seq_tm, lens):
    """Batched 3-pass SMEM collection.

    seq_tm: (B, L) int32 read codes (pad 4); lens: (B,)
    Returns (mem arrays (B, MAX_OUT) x5, mem_n (B,)).
    """
    fn = jax.vmap(lambda s, l: _collect_one(idx, s, l), in_axes=(0, 0))
    return fn(seq_tm, lens)


def smem_batch(fm_or_idx, reads: List[np.ndarray], seq_len: int = 256):
    """Host wrapper: list of nt4 reads -> list of interval dicts per read,
    plus overflow flags (n > MAX_OUT -> host rerun, like the reference)."""
    idx = device_index(fm_or_idx) if isinstance(fm_or_idx, FMIndex) else fm_or_idx
    bsz = len(reads)
    seq_tm = np.full((bsz, seq_len), 4, np.int32)
    lens = np.zeros(bsz, np.int32)
    for k, r in enumerate(reads):
        if len(r) > seq_len:
            raise ValueError("read exceeds seq bucket")
        seq_tm[k, : len(r)] = r
        lens[k] = len(r)
    mem, mem_n = smem_collect_batch(idx, jnp.asarray(seq_tm), jnp.asarray(lens))
    mem = [np.asarray(m) for m in mem]
    mem_n = np.asarray(mem_n)
    out = []
    overflow = mem_n > MAX_OUT
    for k in range(bsz):
        n = int(min(mem_n[k], MAX_OUT))
        out.append(
            [
                dict(
                    x0=int(mem[0][k, j]), x1=int(mem[1][k, j]), s=int(mem[2][k, j]),
                    start=int(mem[3][k, j]), end=int(mem[4][k, j]),
                )
                for j in range(n)
            ]
        )
    return out, overflow

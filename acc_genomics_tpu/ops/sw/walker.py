"""Device-side Smith-Waterman backtrack walker.

The XLA fill (ops/sw/jax_impl.sw_fill) leaves the step-length btrack
matrix row-major, (R, C, B) int16, in device memory; shipping it to the
host costs hundreds of MB per batch and a per-pair reconstruction.  The
walk itself only touches <= reflen + altlen cells per pair, so it runs
on the device as a batched per-lane walk (the same flat-state-machine
pattern as the SMEM engine): each iteration gathers one btrack cell per
lane, takes one step-length-encoded move, and run-length-encodes CIGAR
elements into fixed-size buffers.  Only the tiny element buffers cross
back to the host — the reference keeps the walk on-chip for the same
reason (htc-sw/xlnx/smithWatermanMerlin.cpp: on-chip btrack + final
backtrack).

Start-cell selection (max over the last row / last alt column with
GATK's exact tie-breaking, calculateCigarOneBatch semantics —
htc-sw/host/FalconSW_AVX.cpp:2314-2339) is vectorized over lanes:
the sequential "accept if strictly closer to (reflen, altlen)" chain
reduces to an argmin of 2*|reflen-j| + (j > reflen) over the maximal
cells, with the no-strict-improvement tie gate preserved.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.ops.sw.jax_impl import sw_fill
from acc_genomics_tpu.ops.sw.reference import (
    DEFAULT_SW_PARAMS,
    OVERHANG_IGNORE,
    OVERHANG_INDEL,
    OVERHANG_LEADING_INDEL,
    OVERHANG_SOFTCLIP,
    STATE_CLIP,
    STATE_DELETION,
    STATE_INSERTION,
    STATE_MATCH,
    SWParams,
    sw_align_oracle,
)

I32 = jnp.int32
LOW = jnp.int32(-(1 << 30))
# Element-buffer cap == shipped prefix: en keeps counting past the cap,
# and any pair with more elements reruns on the host (the reference's
# interval-overflow contract).  Small buffers matter: they ride the
# while-loop carry, paying a full read+write per walk step.
MAX_ELEMS = 48
SHIP_ELEMS = MAX_ELEMS


def _write_elem(buf_len, buf_st, slot, ln, stt, mask):
    io = jax.lax.broadcasted_iota(I32, buf_len.shape, 0)
    w = (io == jnp.minimum(slot, MAX_ELEMS - 1)[None, :]) & mask[None, :]
    return (
        jnp.where(w, ln[None, :], buf_len),
        jnp.where(w, stt[None, :], buf_st),
    )


@functools.partial(jax.jit, static_argnames=("strategy",))
def sw_walk_device(btr, lastrow, altcol, reflen, altlen, strategy: int):
    """Batched backtrack from the row-major fill outputs of ``sw_fill``.

    btr: (R, C, B) int16 (rows/cols 1..R/1..C); lastrow: (C+1, B) i32 sw
    at each pair's last real row; altcol: (R, B) i32 sw at each pair's
    last real column; reflen/altlen: (B,).  Returns one packed int16
    array (SHIP_ELEMS+2, B): element lengths, element states, count,
    offset — elements in WALK order (reverse of CIGAR order; the host
    reverses while decoding).
    """
    rows, cols, B = btr.shape
    rl = reflen.astype(I32)
    al = altlen.astype(I32)
    flat = btr.reshape(rows * cols, B)
    lane = jnp.arange(B, dtype=I32)

    # ---- start-cell selection -------------------------------------------
    # altcol[i-1] = sw[i][altlen], i = 1..R
    ii = jax.lax.broadcasted_iota(I32, (rows, B), 0) + 1
    vac = ii <= rl[None, :]
    va = jnp.where(vac, altcol, LOW)
    m1 = jnp.max(va, axis=0)
    # last argmax over i (">=" keeps the largest i)
    p1_a = jnp.max(jnp.where(vac & (va == m1[None, :]), ii, 0), axis=0)

    if strategy == OVERHANG_INDEL:
        p1 = rl
        p2 = al
        seg = jnp.zeros(B, I32)
    elif strategy == OVERHANG_LEADING_INDEL:
        p1 = p1_a
        p2 = al
        seg = jnp.zeros(B, I32)
    else:
        # lastrow[j] = sw[reflen][j], j = 0..C
        jjr = jax.lax.broadcasted_iota(I32, (cols + 1, B), 0)
        vlr = (jjr >= 1) & (jjr <= al[None, :])
        vr = jnp.where(vlr, lastrow, LOW)
        m_lr = jnp.max(vr, axis=0)
        elig = vlr & (vr == m_lr[None, :])
        dist = jnp.abs(rl[None, :] - jjr)
        key = 2 * dist + (jjr > rl[None, :]).astype(I32)
        kmin = jnp.min(jnp.where(elig, key, jnp.int32(1 << 30)), axis=0)
        jstar = jnp.min(
            jnp.where(elig & (key == kmin[None, :]), jjr, jnp.int32(1 << 30)), axis=0
        )
        strict = m_lr > m1
        tie = (m_lr == m1) & ((kmin >> 1) < jnp.abs(p1_a - al))
        upd = strict | tie
        p1 = jnp.where(upd, rl, p1_a)
        p2 = jnp.where(upd, jstar, al)
        seg = jnp.where(upd, al - jstar, 0)

    elem_len = jnp.zeros((MAX_ELEMS, B), I32)
    elem_st = jnp.zeros((MAX_ELEMS, B), I32)
    en = jnp.zeros(B, I32)

    if strategy == OVERHANG_SOFTCLIP:
        flush = seg > 0
        elem_len, elem_st = _write_elem(
            elem_len, elem_st, en, seg, jnp.full(B, STATE_CLIP, I32), flush
        )
        en = jnp.where(flush, 1, 0)
        seg = jnp.zeros(B, I32)

    state = jnp.full(B, STATE_MATCH, I32)

    def cond(s):
        return jnp.any(s["active"])

    def body(s):
        # one btrack cell per lane per step
        p1, p2 = s["p1"], s["p2"]
        act = s["active"]
        cell = (jnp.clip(p1 - 1, 0, rows - 1) * cols
                + jnp.clip(p2 - 1, 0, cols - 1))
        b = flat[cell, lane].astype(I32)
        new_state = jnp.where(b > 0, STATE_DELETION,
                              jnp.where(b < 0, STATE_INSERTION, STATE_MATCH))
        step = jnp.where(b > 0, b, jnp.where(b < 0, -b, 1))
        p1n = jnp.where(new_state == STATE_DELETION, p1 - step,
                        jnp.where(new_state == STATE_MATCH, p1 - 1, p1))
        p2n = jnp.where(new_state == STATE_INSERTION, p2 - step,
                        jnp.where(new_state == STATE_MATCH, p2 - 1, p2))
        changed = act & (new_state != s["state"])
        el, es = _write_elem(
            s["elem_len"], s["elem_st"], s["en"], s["seg"], s["state"], changed
        )
        en2 = jnp.where(changed, s["en"] + 1, s["en"])
        seg2 = jnp.where(act, jnp.where(changed, step, s["seg"] + step), s["seg"])
        st2 = jnp.where(changed, new_state, s["state"])
        p1o = jnp.where(act, p1n, p1)
        p2o = jnp.where(act, p2n, p2)
        return dict(
            p1=p1o, p2=p2o, state=st2, seg=seg2, en=en2,
            elem_len=el, elem_st=es,
            active=act & (p1o > 0) & (p2o > 0),
        )

    init = dict(
        p1=p1, p2=p2, state=state, seg=seg, en=en,
        elem_len=elem_len, elem_st=elem_st,
        active=(p1 > 0) & (p2 > 0) & (rl > 0) & (al > 0),
    )
    def body4(s):
        # 4 steps per iteration: fewer loop-predicate evaluations and
        # carry round trips per gather step
        for _ in range(4):
            s = body(s)
        return s

    fin = jax.lax.while_loop(cond, body4, init)
    p1, p2 = fin["p1"], fin["p2"]
    seg, state, en = fin["seg"], fin["state"], fin["en"]
    elem_len, elem_st = fin["elem_len"], fin["elem_st"]
    ones = jnp.ones(B, bool)

    if strategy == OVERHANG_SOFTCLIP:
        elem_len, elem_st = _write_elem(elem_len, elem_st, en, seg, state, ones)
        en = en + 1
        clip = p2 > 0
        elem_len, elem_st = _write_elem(
            elem_len, elem_st, en, p2, jnp.full(B, STATE_CLIP, I32), clip
        )
        en = jnp.where(clip, en + 1, en)
        offset = p1
    elif strategy == OVERHANG_IGNORE:
        elem_len, elem_st = _write_elem(elem_len, elem_st, en, seg + p2, state, ones)
        en = en + 1
        offset = p1 - p2
    else:
        elem_len, elem_st = _write_elem(elem_len, elem_st, en, seg, state, ones)
        en = en + 1
        dmask = p1 > 0
        imask = (p1 <= 0) & (p2 > 0)
        elem_len, elem_st = _write_elem(
            elem_len, elem_st, en, p1, jnp.full(B, STATE_DELETION, I32), dmask
        )
        elem_len, elem_st = _write_elem(
            elem_len, elem_st, en, p2, jnp.full(B, STATE_INSERTION, I32), imask
        )
        en = jnp.where(dmask | imask, en + 1, en)
        offset = jnp.zeros(B, I32)

    # one packed int16 payload: element length (<= 3072, 12 bits) and
    # state (3 bits) share an int16 (len | st << 12); only the first
    # SHIP_ELEMS elements ship (real CIGARs have ~5-10; longer ones rerun
    # on the host like buffer overflows).  One array, one transfer.
    lens = jnp.concatenate([elem_len[:SHIP_ELEMS], en[None, :], offset[None, :]])
    states = jnp.concatenate(
        [elem_st[:SHIP_ELEMS], jnp.zeros((2, B), I32)]
    )
    return (lens | (states << 12)).astype(jnp.int16)


def decode_elements(packed, n_real):
    """Packed walk-order element buffer (SHIP_ELEMS+2, B) -> [(cigar,
    offset)] in CIGAR order.  Returns (results, overflow mask); overflow
    pairs need a host rerun."""
    packed = np.asarray(packed)
    elem_len = packed[:SHIP_ELEMS] & 0x0FFF
    elem_st = (packed[:SHIP_ELEMS] >> 12) & 0x7
    en = packed[SHIP_ELEMS]
    offset = packed[SHIP_ELEMS + 1]
    out = []
    overflow = en > SHIP_ELEMS
    for k in range(n_real):
        if overflow[k]:
            out.append(None)
            continue
        n = int(en[k])
        cig = [
            (int(elem_len[j, k]), int(elem_st[j, k])) for j in range(n - 1, -1, -1)
        ]
        out.append((cig, int(offset[k])))
    return out, overflow


@functools.partial(jax.jit, static_argnames=("strategy", "params"))
def sw_align_device(ref_tm, alt_tm, reflen, altlen, strategy: int,
                    params: SWParams = DEFAULT_SW_PARAMS):
    """XLA fill + device walk in one program: (R, B) / (C, B) codes (any
    int dtype, pad >= 4) -> the walker's packed element buffer.  The
    btrack matrix lives and dies inside the program."""
    btr, lastrow, altcol = sw_fill(
        ref_tm.astype(I32), alt_tm.astype(I32), reflen.astype(I32),
        altlen.astype(I32), strategy, params,
    )
    return sw_walk_device(btr, lastrow, altcol, reflen, altlen, strategy)


def pack_sw_batch(refs, alts, rows: int, cols: int, lane_multiple: int = 8):
    """Time-major uint8 (rows, B) / (cols, B) code buffers (pad 255) and
    (B,) lengths, B padded to a power of two >= lane_multiple (few jit
    shapes) and to a multiple of it."""
    n = len(refs)
    bsz = 8
    while bsz < n:
        bsz *= 2
    bsz = -(-max(bsz, lane_multiple) // lane_multiple) * lane_multiple
    ref_tm = np.full((rows, bsz), 255, np.uint8)
    alt_tm = np.full((cols, bsz), 255, np.uint8)
    reflen = np.zeros(bsz, np.int32)
    altlen = np.zeros(bsz, np.int32)
    for k, (r, a) in enumerate(zip(refs, alts)):
        if len(r) > rows or len(a) > cols:
            raise ValueError("sequence exceeds bucket")
        ref_tm[: len(r), k] = r
        alt_tm[: len(a), k] = a
        reflen[k] = len(r)
        altlen[k] = len(a)
    return ref_tm, alt_tm, reflen, altlen


def sw_align_batch_launch(
    refs, alts, strategy: int, rows: int, cols: int, mesh=None,
    params: SWParams = DEFAULT_SW_PARAMS, device=None,
):
    """Pack and launch fill + device walk; returns the packed element
    buffer as a device array without fetching it — callers batch many
    launches into one transfer and decode with sw_align_batch_decode."""
    dsz = int(mesh.shape["data"]) if mesh is not None else 1
    host = pack_sw_batch(refs, alts, rows, cols, lane_multiple=max(8, dsz))
    if mesh is not None:
        from acc_genomics_tpu.parallel.sharded import shard_lanes
        from acc_genomics_tpu.parallel.sharded_kernels import sw_device_dp

        return sw_device_dp(
            mesh, *shard_lanes(mesh, host), strategy, params=params
        )
    args = [jax.device_put(a, device) for a in host]
    return sw_align_device(*args, strategy, params)


def sw_align_batch_decode(
    packed_np, refs, alts, strategy: int,
    params: SWParams = DEFAULT_SW_PARAMS, stats: Optional[dict] = None,
) -> List[Tuple[list, int]]:
    """Host half: decode a fetched packed element buffer into per-pair
    (cigar, offset); pairs whose element count overflowed the walker's
    buffer rerun on the native host engine and are counted in
    ``stats["walk_overflow"]`` when ``stats`` is given."""
    from acc_genomics_tpu import native

    out, overflow = decode_elements(packed_np, len(refs))
    over = np.flatnonzero(overflow[: len(refs)])
    if stats is not None:
        stats["walk_overflow"] = stats.get("walk_overflow", 0) + len(over)
    if len(over):
        redo = native.sw_align_host(
            [refs[k] for k in over], [alts[k] for k in over], strategy, params
        )
        for k, res in zip(over, redo):
            out[k] = res if res is not None else sw_align_oracle(
                refs[k], alts[k], strategy, params=params
            )
    return out


def sw_align_batch_device(
    refs, alts, strategy: int, rows: int, cols: int, mesh=None,
    params: SWParams = DEFAULT_SW_PARAMS,
) -> List[Tuple[list, int]]:
    """Batched alignment on the device: XLA fill + device walker; only
    the CIGAR element buffers leave the device.  Exact against
    ops.sw.reference.sw_align_oracle."""
    packed = sw_align_batch_launch(
        refs, alts, strategy, rows, cols, mesh=mesh, params=params
    )
    return sw_align_batch_decode(
        np.asarray(packed), refs, alts, strategy, params=params
    )

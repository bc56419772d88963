"""Batched XLA banded seed extension.

One lane per extension task; a lax.scan walks target rows.  Each row:

* M comes from the previous row's shifted H (the eh_h register file of
  the reference becomes a (Q+2, B) carry),
* E is elementwise, F's within-row chain
      f(j) = max_{k<j in band} max(M(k)-oe_ins, 0) - (j-1-k)*e_ins
  is a running max of ``t(k) + k*e_ins`` (cummax along the row axis),
* the adaptive band [beg, end) is a pair of per-lane registers; all row
  math is masked to the band, reproducing the reference's zero-run
  narrowing, break conditions, and two-round band doubling exactly
  (bwa-sw/sdaccel/smithwaterman.cpp:75-273).

Integer DP -> results are bit-identical to the oracle; compared exactly
in tests.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.ops.extend.reference import (
    DEFAULT_EXTEND_PARAMS,
    ExtendParams,
    PEN_CLIP,
)

I32 = jnp.int32
NEG = jnp.int32(-(1 << 29))


def _cummax_log(u):
    """Inclusive running max along axis 0 as a log-depth shift-max ladder
    (the Kogge-Stone max_scan of htc-sw/host/FalconSW_AVX.cpp:38-300)."""
    n = u.shape[0]
    sh = 1
    while sh < n:
        shifted = jnp.concatenate([jnp.full((sh,) + u.shape[1:], NEG, u.dtype), u[:-sh]], axis=0)
        u = jnp.maximum(u, shifted)
        sh <<= 1
    return u


@functools.partial(jax.jit, static_argnames=("params",))
def sw_extend_batch(
    q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
    params: ExtendParams = DEFAULT_EXTEND_PARAMS,
):
    """Banded extension for a batch of tasks.

    q_tm: (Q, B) int32 query codes (pad 4)
    t_tm: (T, B) int32 target codes
    qlen/tlen/h0/max_ins/max_del: (B,) int32
    params: static scoring options (mem_opt_t analog)
    Returns dict of (B,) int32: score qle tle gtle gscore max_off w.
    """
    O_DEL, E_DEL, O_INS, E_INS = (
        params.o_del, params.e_del, params.o_ins, params.e_ins
    )
    W_IN = params.w
    Q, bsz = q_tm.shape
    T = t_tm.shape[0]
    oe_del = O_DEL + E_DEL
    oe_ins = O_INS + E_INS

    jj = jnp.arange(Q, dtype=I32)[:, None]  # (Q, 1) column index
    # score of query base j against a given target base, per row: gather
    # mat[q_i, q_j] -> compute per row inside scan

    def zeros(shape):
        return jnp.zeros(shape, I32) + (h0[None, :] * 0 if len(shape) == 2 else h0 * 0)

    # per-round state that persists across BOTH rounds: eh arrays + maxima
    def run_round(k, state):
        (eh_h, eh_e, max_score, max_i, max_j, max_ie, gscore, max_off,
         reg_score, aw_used, done_all) = state
        prev = reg_score
        band_w = jnp.asarray(W_IN << k, I32) + (h0 * 0)
        aw1 = jnp.minimum(jnp.minimum(band_w, max_ins), max_del)
        # round active per lane: rounds run while not done
        round_active = jnp.logical_not(done_all)
        aw_used = jnp.where(round_active, band_w, aw_used)

        row0_h = jnp.maximum(h0 - oe_ins, 0)
        # row-0 M values: j==0 -> h0; j>=1 -> max(row0_h - (j-1)*e_ins, 0)
        row0_m = jnp.where(
            jj == 0, h0[None, :], jnp.maximum(row0_h[None, :] - (jj - 1) * E_INS, 0)
        )

        beg0 = zeros((bsz,))
        end0 = qlen
        h1_init0 = h0 - O_DEL
        alive0 = round_active

        def row_step(carry, row_in):
            (eh_h, eh_e, beg, end, h1_init, alive,
             max_score, max_i, max_j, max_ie, gscore, max_off) = carry
            t_i, i = row_in  # (B,), scalar
            beg = jnp.maximum(beg, i - aw1)
            end = jnp.minimum(jnp.minimum(end, i + aw1 + 1), qlen)
            at0 = beg == 0
            h1_init = jnp.where(alive & at0, h1_init - E_DEL, h1_init)
            h1_beg = jnp.where(at0, jnp.maximum(h1_init, 0), 0)

            in_band = (jj >= beg[None, :]) & (jj < end[None, :])
            # per-cell score mat[t_i, q_j], computed arithmetically (no
            # 2D table gather per row): match +1, mismatch -4,
            # either-ambiguous -1 (bwa_fill_scmat)
            tb = t_i[None, :]
            amb = (tb >= 4) | (q_tm >= 4)
            sc = jnp.where(
                amb,
                jnp.asarray(params.sc_ambig, I32),
                jnp.where(
                    tb == q_tm,
                    jnp.asarray(params.sc_match, I32),
                    jnp.asarray(params.sc_mismatch, I32),
                ),
            )
            m_in = jnp.where(i == 0, row0_m, eh_h[:Q])
            e_in = jnp.where(i == 0, 0, eh_e[:Q])
            M = jnp.where(m_in != 0, m_in + sc, 0)
            t_del = jnp.maximum(M - oe_del, 0)
            e_out = jnp.maximum(e_in - E_DEL, t_del)
            t_ins = jnp.maximum(M - oe_ins, 0)
            # f chain: f(j) = max_{k<j in band} t_ins(k) - (j-1-k)*E_INS,
            # never negative since t_ins >= 0 and k=j-1 contributes t_ins
            # undecayed; f(beg) = 0.  With run(x) = cummax(t_ins + k*E):
            # f(j) = run(j-1) - (j-1)*E, clamped at 0.
            u = jnp.where(in_band, t_ins + jj * E_INS, NEG)
            run = _cummax_log(u)
            f = jnp.concatenate(
                [jnp.full((1, bsz), NEG, I32), run[:-1]], axis=0
            ) - (jj - 1) * E_INS
            f = jnp.maximum(f, 0)
            # h = max(M, e_in, f) — but f at j uses t from k<j only (f(beg)=0 ✓
            # because run before beg is NEG -> clamped to 0)
            h = jnp.maximum(jnp.maximum(M, e_in), f)
            h = jnp.where(in_band, h, 0)

            # H(i, j-1) row: shift h down, inject h1_beg at j==beg
            hprev = jnp.concatenate([jnp.zeros((1, bsz), I32), h[:-1]], axis=0)
            hprev = jnp.where(jj == beg[None, :], h1_beg[None, :], hprev)

            # h1 after the loop = H(i, end-1) (or h1_beg if band empty);
            # masked reduce instead of a per-row gather
            band_nonempty = end > beg
            h_end = jnp.max(
                jnp.where(jj == jnp.maximum(end - 1, 0)[None, :], h, NEG), axis=0
            )
            h1_last = jnp.where(band_nonempty, h_end, h1_beg)

            # m / mj: running "m <= h" keeps the LAST argmax among visited j
            h_band = jnp.where(in_band, h, -1)
            m = jnp.maximum(jnp.max(h_band, axis=0), 0)
            # last index where h_band == m (only meaningful when m>0 or band
            # nonempty; mj=-1 when nothing visited... the scalar sets mj to
            # the last visited j when all h==0; replicate: among in_band,
            # last j with h == m; if band empty mj = -1
            eq = in_band & (h_band == m[None, :])
            mj = jnp.max(jnp.where(eq, jj, -1), axis=0)

            # zero-run trackers over (hprev==0 & e_out==0) within the band
            zcond = (hprev == 0) & (e_out == 0)
            zc_band = jnp.where(in_band, zcond, False)
            # forward: leading True run from beg
            not_z = in_band & jnp.logical_not(zcond)
            first_false = jnp.min(jnp.where(not_z, jj, Q), axis=0)
            forw = jnp.clip(first_false, beg, end) - beg
            # backward: trailing True run up to end-1
            last_false = jnp.max(jnp.where(not_z, jj, -1), axis=0)
            trail = jnp.where(
                band_nonempty, end - 1 - jnp.maximum(last_false, beg - 1), 0
            )
            backw = jnp.where(h1_last == 0, trail + 1, 0)

            # update eh in [beg, end] (stale outside, like the reference)
            upd = in_band
            eh_h_new = jnp.where(upd, hprev, eh_h[:Q])
            eh_e_new = jnp.where(upd, e_out, eh_e[:Q])
            eh_h_new = jnp.concatenate([eh_h_new, eh_h[Q:]], axis=0)
            eh_e_new = jnp.concatenate([eh_e_new, eh_e[Q:]], axis=0)
            # eh[end] = (h1, 0)
            endx = end[None, :]
            jj2 = jnp.arange(Q + 2, dtype=I32)[:, None]
            eh_h_new = jnp.where(jj2 == endx, h1_last[None, :], eh_h_new)
            eh_e_new = jnp.where(jj2 == endx, 0, eh_e_new)

            row_active = alive & (i < tlen)
            eh_h = jnp.where(row_active[None, :], eh_h_new, eh_h)
            eh_e = jnp.where(row_active[None, :], eh_e_new, eh_e)

            # gscore (before break check); the scalar tests the loop
            # variable j == qlen, which is end for a nonempty band and beg
            # for an empty one
            j_after = jnp.maximum(beg, end)
            gupd = row_active & (j_after == qlen) & (gscore <= h1_last)
            max_ie = jnp.where(gupd, i, max_ie)
            gscore = jnp.where(gupd, h1_last, gscore)

            brk = row_active & (m == 0)
            alive = alive & jnp.logical_not(brk)
            mupd = row_active & jnp.logical_not(brk) & (m > max_score)
            max_score = jnp.where(mupd, m, max_score)
            max_i = jnp.where(mupd, i, max_i)
            max_j = jnp.where(mupd, mj, max_j)
            off = jnp.abs(mj - i)
            max_off = jnp.where(mupd & (off > max_off), off, max_off)

            beg = jnp.where(row_active, beg + forw, beg)
            end = jnp.where(
                row_active,
                jnp.minimum(end - backw + 2, qlen),
                end,
            )
            return (
                eh_h, eh_e, beg, end, h1_init, alive,
                max_score, max_i, max_j, max_ie, gscore, max_off,
            ), None

        carry0 = (
            eh_h, eh_e, beg0, end0, h1_init0, alive0,
            max_score, max_i, max_j, max_ie, gscore, max_off,
        )
        rows = jnp.arange(T, dtype=I32)
        (eh_h, eh_e, _, _, _, _, max_score, max_i, max_j, max_ie, gscore,
         max_off), _ = jax.lax.scan(row_step, carry0, (t_tm, rows))

        reg_score = jnp.where(round_active, max_score, reg_score)
        brk = (max_score == prev) | (max_off < ((band_w >> 1) + (band_w >> 2)))
        done_all = done_all | (round_active & brk) | jnp.logical_not(round_active)
        return (
            eh_h, eh_e, max_score, max_i, max_j, max_ie, gscore, max_off,
            reg_score, aw_used, done_all,
        )

    # all state derives from h0 so it inherits the varying mesh axes under
    # shard_map (scan carry in/out types must match exactly)
    zb = h0 * 0
    neg1 = zb - 1
    state = (
        jnp.zeros((Q + 2, bsz), I32) + (h0[None, :] * 0),
        jnp.zeros((Q + 2, bsz), I32) + (h0[None, :] * 0),
        h0,  # max_score
        neg1, neg1, neg1,  # max_i, max_j, max_ie
        neg1,  # gscore
        zb,  # max_off
        h0,  # reg_score
        zb + W_IN,  # aw_used
        zb > 0,  # done
    )
    state = run_round(0, state)
    state = run_round(1, state)
    (_, _, max_score, max_i, max_j, max_ie, gscore, max_off,
     reg_score, aw_used, _) = state
    return dict(
        score=reg_score,
        qle=max_j + 1,
        tle=max_i + 1,
        gtle=max_ie + 1,
        gscore=gscore,
        max_off=max_off,
        w=aw_used,
    )


def extend_tasks_batch(
    tasks, max_q: int, max_t: int,
    params: ExtendParams = DEFAULT_EXTEND_PARAMS,
) -> Dict[str, np.ndarray]:
    """tasks: list of dicts with query/target nt4 arrays and h0.
    Pads and runs the batched extension; returns dict of (B,) arrays."""
    bsz = len(tasks)
    q_tm = np.full((max_q, bsz), 4, np.int32)
    t_tm = np.full((max_t, bsz), 4, np.int32)
    qlen = np.zeros(bsz, np.int32)
    tlen = np.zeros(bsz, np.int32)
    h0 = np.zeros(bsz, np.int32)
    for k, t in enumerate(tasks):
        q, tg = t["query"], t["target"]
        if len(q) > max_q or len(tg) > max_t:
            raise ValueError("task exceeds bucket")
        q_tm[: len(q), k] = q
        t_tm[: len(tg), k] = tg
        qlen[k] = len(q)
        tlen[k] = len(tg)
        h0[k] = t["h0"]
    res = sw_extend_batch(
        jnp.asarray(q_tm), jnp.asarray(t_tm), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(h0), jnp.asarray(qlen), jnp.asarray(qlen),
        params=params,
    )
    return {k: np.asarray(v) for k, v in res.items()}

"""Pure-XLA batched PairHMM forward pass.

A row-wise lax.scan over the read dimension in **time-major layout**:
all state is (H+1, B) with the batch on the minor (lane) axis and the
hap column dimension on the major axis, so every shift is a row offset
and nothing is ever transposed on device.  M and X rows are
elementwise functions of the previous row; the within-row Y recurrence
``y[c] = a[c] + pYY * y[c-1]`` is a first-order linear recurrence
evaluated with ``lax.associative_scan`` (log-depth, lane-parallel) —
the XLA analog of the reference AVX stripe kernel's shift-carry
(pairhmm/xlnx/host/avx-pairhmm-template.h:210-346), redesigned for a
batch-wide vector machine instead of 8-lane AVX.

Variable lengths are handled by the packed-batch absorbing-row layout
(see pack.py) so the whole scan is dense with no per-pair control flow.
This implementation runs on any XLA backend and is the portable path
the Pallas kernel is checked against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.ops.pairhmm.pack import PackedPairHMMBatch
from acc_genomics_tpu.utils.convert import BASE_N, HAP_PAD


def _linear_scan(a: jnp.ndarray, b: jnp.ndarray, axis: int) -> jnp.ndarray:
    """y[i] = a[i] + b[i] * y[i-1] along ``axis`` (y[-1] = 0)."""

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 + b2 * a1, b1 * b2

    y, _ = jax.lax.associative_scan(combine, (a, b), axis=axis)
    return y


@jax.jit
def pairhmm_forward(
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy,
    em_match, em_mis, rs, hap_ext, y0,
):
    """Batched forward probability.

    All per-row arrays are time-major (R, B) with absorbing rows beyond
    each read's length; hap_ext is (R + H, B) with HAP_PAD sentinels
    (only the first H rows are used here).  Returns (B,) raw forward
    probabilities in the coefficient dtype.
    """
    dtype = p_mm.dtype
    rows, bsz = p_mm.shape
    cols = hap_ext.shape[0] - rows
    hap = hap_ext[:cols]  # (H, B)
    hap_is_n = hap == BASE_N
    hap_pad_zero = jnp.where(hap >= HAP_PAD, dtype.type(0), dtype.type(1))

    # derive the zero carries from y0 so they inherit its device-varying
    # axes under shard_map (plain jnp.zeros would be axis-invariant and
    # trip scan's carry type check)
    zcol = (y0[None, :] * dtype.type(0)).astype(dtype)
    m0 = jnp.broadcast_to(zcol, (cols + 1, bsz))
    x0 = m0
    yrow0 = jnp.broadcast_to(y0[None, :], (cols + 1, bsz)).astype(dtype)
    zero_row = jnp.zeros((1, bsz), dtype)

    xs = (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs)

    def step(carry, row):
        m_prev, x_prev, y_prev = carry
        (c_mm, c_gapm, c_mx, c_xx, c_my, c_yy, e_m, e_x, rs_r) = row
        match = (hap == rs_r[None, :]) | (rs_r == BASE_N)[None, :] | hap_is_n
        distm = jnp.where(match, e_m[None, :], e_x[None, :]) * hap_pad_zero
        m_body = distm * (
            m_prev[:-1] * c_mm[None, :]
            + (x_prev[:-1] + y_prev[:-1]) * c_gapm[None, :]
        )
        m_new = jnp.concatenate([zero_row, m_body], axis=0)
        x_new = m_prev * c_mx[None, :] + x_prev * c_xx[None, :]
        # y[c] = m_new[c-1]*pMY + pYY*y[c-1]; y[0] = 0
        a = jnp.concatenate([zero_row, m_new[:-1] * c_my[None, :]], axis=0)
        b = jnp.concatenate(
            [zero_row, jnp.broadcast_to(c_yy[None, :], (cols, bsz))], axis=0
        )
        y_new = _linear_scan(a, b, axis=0)
        return (m_new, x_new, y_new), None

    (m_f, x_f, _), _ = jax.lax.scan(step, (m0, x0, yrow0), xs)
    del m_f  # absorbing rows fold M into X; final row M is all zero
    return x_f.sum(axis=0)


def pairhmm_loglik(result, log10_initial_constant):
    """log10(result) - LOG10_INITIAL_CONSTANT (FalconPairHMM.cpp:634-656)."""
    return jnp.log10(result) - log10_initial_constant


def forward_from_pack(pack: PackedPairHMMBatch):
    """Convenience wrapper over numpy-packed batches."""
    if pack.p_mm.dtype == np.float64 and not jax.config.jax_enable_x64:
        # Without x64, jax silently casts to f32 and INITIAL_CONSTANT=2^1020
        # overflows to inf.  The engine's fp64 underflow-recompute path uses
        # the NumPy oracle instead (engine/dispatch.py); direct fp64 use of
        # the jax path requires x64.
        raise ValueError(
            "fp64 PairHMM via jax requires jax_enable_x64; use the NumPy "
            "oracle for host-side fp64 recompute"
        )
    return pairhmm_forward(*[jnp.asarray(v) for v in pack.arrays()])

"""Multi-device PairHMM via shard_map over a ("data", "seq") mesh.

* ``pairhmm_forward_dp``: batch lanes sharded over "data"; no
  communication at all (pairs are independent) — the throughput path,
  replacing the reference's Blaze tiling across FPGA workers.  Each
  shard runs the XLA row scan or the Pallas wavefront kernel.

* ``pairhmm_forward_dpsp``: additionally shards haplotype columns over
  "seq".  The row scan then needs three collectives per row:
    - a ppermute handing each shard its left neighbour's previous-row
      last column (the diagonal ghost cell for M),
    - a ppermute of the current row's M last column (the drive of the
      first local Y term), and
    - an all_gather of per-shard affine aggregates (A, B) of the
      within-row Y recurrence y[c] = a[c] + b * y[c-1]; shard k's
      carry-in is the left-to-right composition of aggregates 0..k-1.
  This is true sequence parallelism for a linear-recurrence DP — the
  collective-based replacement for the reference's host-side segmentation of
  oversized haplotypes (pairhmm/host/PairHMMFpga.cpp:284-332).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from acc_genomics_tpu.ops.pairhmm.jax_impl import pairhmm_forward, _linear_scan
from acc_genomics_tpu.utils.convert import BASE_N, HAP_PAD


# Each distributed form memoizes one jitted shard_map per mesh: building
# a fresh shard_map per call retraces (and recompiles) every invocation —
# measured seconds per call on the scaling driver.


@functools.lru_cache(maxsize=None)
def _dp_fn(mesh: Mesh, kernel: str, interpret: bool):
    spec_rb = P(None, "data")
    spec_b = P("data")
    if kernel == "xla":
        return jax.jit(jax.shard_map(
            pairhmm_forward,
            mesh=mesh,
            in_specs=(spec_rb,) * 10 + (spec_b,),
            out_specs=spec_b,
        ))
    from acc_genomics_tpu.ops.pairhmm.kernel import pairhmm_forward_pallas

    def local(*args):
        return pairhmm_forward_pallas(*args, interpret=interpret)

    return jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_rb,) * 10 + (spec_b,) * 3,
        out_specs=spec_b,
        # pallas_call outputs carry no varying-mesh-axes annotation; the
        # kernel is purely per-shard, so vma checking adds nothing here
        check_vma=False,
    ))


def pairhmm_forward_dp(mesh: Mesh, *packed_arrays, rslen=None, haplen=None,
                       kernel: str = "xla", interpret: bool = False):
    """Data-parallel forward: shard the lane axis over "data".

    packed_arrays are the time-major arrays of pack.py; the batch must
    divide by the data-axis size (and, for ``kernel="pallas"``, each
    shard by the kernel's block).  The Pallas kernel also takes the
    per-lane read / haplotype lengths.
    """
    if kernel == "xla":
        return _dp_fn(mesh, kernel, False)(*packed_arrays)
    return _dp_fn(mesh, kernel, interpret)(*packed_arrays, rslen, haplen)


@functools.partial(
    jax.jit, static_argnames=("mesh", "initial_constant", "kernel")
)
def pairhmm_forward_dp_from_quals(
    mesh: Mesh, q, i, d, c, rs, hap_ext, rslen, haplen,
    initial_constant: float, kernel: str = "xla",
):
    """Data-parallel forward from lane-sharded byte planes (the arrays of
    ``PackedPairHMMQuals``, placed by :func:`shard_lanes`): each device
    expands its own lanes' coefficients (the expansion is elementwise
    over lanes, so no data moves) and runs :func:`pairhmm_forward_dp`."""
    from acc_genomics_tpu.ops.pairhmm.kernel import expand_quals

    planes, rs, hap_ext, y0 = expand_quals(
        q, i, d, c, rs, hap_ext, rslen, haplen, jnp.float32(initial_constant)
    )
    return pairhmm_forward_dp(
        mesh, *planes, rs, hap_ext, y0, rslen=rslen, haplen=haplen,
        kernel=kernel,
    )


def shard_lanes(mesh: Mesh, arrays):
    """Place host arrays on the mesh with their last (lane) axis split
    over "data", so each device receives only its shard."""
    from jax.sharding import NamedSharding

    out = []
    for a in arrays:
        spec = P(*([None] * (np.ndim(a) - 1)), "data")
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return out


def _sp_forward_local(
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs, hap_loc, y0
):
    """Per-shard body for DP x SP.  hap_loc: (Hc, B) local hap columns;
    shard k owns global interior columns [k*Hc+1 .. (k+1)*Hc]."""
    dtype = p_mm.dtype
    rows, bsz = p_mm.shape
    hc = hap_loc.shape[0]
    seq_ax = "seq"
    n_seq = jax.lax.axis_size(seq_ax)
    my_seq = jax.lax.axis_index(seq_ax)
    is_first = my_seq == 0
    right_perm = [(i, (i + 1) % n_seq) for i in range(n_seq)]

    hap_is_n = hap_loc == BASE_N
    hap_pad_zero = jnp.where(hap_loc >= HAP_PAD, dtype.type(0), dtype.type(1))

    # zero carries derived from y0 so they inherit its varying axes under
    # shard_map (scan requires carry in/out types to match exactly)
    # include a hap_loc term so the zeros vary over BOTH mesh axes
    zrow = ((y0[None, :] + hap_loc[:1].astype(dtype)) * dtype.type(0)).astype(dtype)
    m0 = jnp.broadcast_to(zrow, (hc, bsz))
    x0 = m0
    y00 = jnp.broadcast_to(y0[None, :], (hc, bsz)).astype(dtype) + jnp.broadcast_to(
        zrow, (hc, bsz)
    )
    # ghost = previous row's value at the left neighbour's last column
    # (global column k*Hc).  Row 0: M=X=0, Y=IC/haplen everywhere.
    ghost0 = (zrow, zrow, y0[None, :].astype(dtype) + zrow)
    zero_row = zrow
    zero_vec = zrow[0]

    def shift_from_left(v_last_row, fill):
        """Give each shard its left neighbour's (1, B) row; shard 0 gets fill."""
        got = jax.lax.ppermute(v_last_row, seq_ax, right_perm)
        return jnp.where(is_first, fill, got)

    def step(carry, row):
        (m_prev, x_prev, y_prev, gm, gx, gy) = carry
        (c_mm, c_gapm, c_mx, c_xx, c_my, c_yy, e_m, e_x, rs_r) = row
        match = (hap_loc == rs_r[None, :]) | (rs_r == BASE_N)[None, :] | hap_is_n
        distm = jnp.where(match, e_m[None, :], e_x[None, :]) * hap_pad_zero

        # M and X from the previous row (ghost provides the cross-shard
        # diagonal term)
        m_shift = jnp.concatenate([gm, m_prev[:-1]], axis=0)
        sxy_shift = jnp.concatenate([gx + gy, (x_prev + y_prev)[:-1]], axis=0)
        m_new = distm * (m_shift * c_mm[None, :] + sxy_shift * c_gapm[None, :])
        x_new = m_prev * c_mx[None, :] + x_prev * c_xx[None, :]

        # Y: y[t] = a[t] + b*y[t-1] across the full row.  The first local
        # drive needs this row's M at the left neighbour's last column.
        m_left_last = shift_from_left(m_new[-1:], zero_row)  # (1, B)
        a = jnp.concatenate([m_left_last * c_my[None, :], m_new[:-1] * c_my[None, :]], axis=0)
        b_full = jnp.broadcast_to(c_yy[None, :], (hc, bsz))
        y_loc0 = _linear_scan(a, b_full, axis=0)  # zero carry-in
        p_cum = jnp.cumprod(b_full, axis=0)

        # shard aggregates: y_out = A + B * y_in
        agg_a = jax.lax.all_gather(y_loc0[-1], seq_ax)  # (n_seq, B)
        agg_b = jax.lax.all_gather(p_cum[-1], seq_ax)
        y_in = zero_vec
        carries = [y_in]
        for j in range(n_seq - 1):
            y_in = agg_a[j] + agg_b[j] * y_in
            carries.append(y_in)
        my_carry = jnp.stack(carries)[my_seq]  # (B,)
        y_new = y_loc0 + p_cum * my_carry[None, :]

        gm_n = shift_from_left(m_new[-1:], zero_row)
        gx_n = shift_from_left(x_new[-1:], zero_row)
        gy_n = shift_from_left(y_new[-1:], zero_row)
        return (m_new, x_new, y_new, gm_n, gx_n, gy_n), None

    xs = (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs)
    init = (m0, x0, y00) + ghost0
    (m_f, x_f, y_f, *_), _ = jax.lax.scan(step, init, xs)
    local = x_f.sum(axis=0)
    return jax.lax.psum(local, seq_ax)


def pairhmm_forward_dpsp(mesh: Mesh, *packed_arrays):
    """DP x SP forward over a 2-axis mesh.

    packed_arrays as pack.py (time-major); hap columns must divide by the
    seq-axis size, batch by the data-axis size.  Uses the (R+H,B) hap_ext
    array's first H rows.
    """
    (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x, rs, hap_ext, y0) = packed_arrays
    rows = p_mm.shape[0]
    cols = hap_ext.shape[0] - rows
    hap = hap_ext[:cols]
    return _dpsp_fn(mesh)(
        p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x, rs, hap, y0
    )


@functools.lru_cache(maxsize=None)
def _dpsp_fn(mesh: Mesh):
    spec_rb = P(None, "data")
    spec_hb = P("seq", "data")
    spec_b = P("data")
    return jax.jit(jax.shard_map(
        _sp_forward_local,
        mesh=mesh,
        in_specs=(spec_rb,) * 9 + (spec_hb, spec_b),
        out_specs=spec_b,
    ))

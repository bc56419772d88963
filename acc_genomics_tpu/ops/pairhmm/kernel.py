"""Pallas (Triton) kernel for the batched PairHMM forward pass on Hopper.

One GPU thread owns one (read, hap) pair; a program is a block of
``block`` pairs (32 or 64: one or two warps), so an 8192-pair batch is
128-256 programs spread over the card's SMs.  This is the wavefront of
the reference's PE array (pairhmm/xlnx/device/pairhmm.cpp:83-391) and of
gpuPairHMM (PAPERS.md), laid out for a thread per matrix:

* the read rows advance in **bands of C rows** held in registers as C
  separate vectors in the column loop's carry.  Within a band the rows
  are skewed by one column each: at step t, band row r computes column
  c = t - r + 1, so its left neighbour is its own previous value, its up
  neighbour is row r-1's previous value, and its diagonal is row r-1's
  value from the step before that.  A static shift of the vectors
  replaces a rotate of the wavefront;
* the band's bottom row streams to a global scratch row (M, X, Y per
  column) that the next band's top row reads back one column ahead of
  where it writes.  The scratch starts as the virtual row -1
  (M = X = 0, Y = IC / haplen), so the first band needs no special case;
* each program derives its own trip counts from its lanes' lengths: the
  number of bands from the longest read in the block (rows past it are
  absorbing and leave X unchanged), the number of columns from the
  longest haplotype.  Packing sorted by haplotype length keeps the
  blocks tight (the reference's sortReads, FalconPairHMM.cpp:268).

Cell (i, c) (read row i, hap column c >= 1):
    M(i,c) = distm(i,c) * (pMM(i) M(i-1,c-1) + pGapM(i) (X+Y)(i-1,c-1))
    X(i,c) = pMX(i) M(i-1,c) + pXX(i) X(i-1,c)
    Y(i,c) = pMY(i) M(i,c-1) + pYY(i) Y(i,c-1)
with column 0 all zero.  The absorbing-row layout of pack.py makes the
result the sum of X over the last row.  All arithmetic is float32 outside
the tensor cores; no matrix product is involved.

``pairhmm_forward_pallas`` takes the same arrays as the XLA row scan
(``jax_impl.pairhmm_forward``) plus the per-lane lengths, and the
``*_from_quals*`` wrappers expand uploaded quality bytes into
coefficient planes in plain jnp and feed either forward
(``kernel="pallas"`` or ``"xla"``).  ``interpret=True`` runs the kernel
in the Pallas interpreter, which is how the CPU tests reach it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from acc_genomics_tpu.ops.pairhmm.jax_impl import pairhmm_forward
from acc_genomics_tpu.ops.pairhmm.pack import PackedPairHMMBatch
from acc_genomics_tpu.utils.convert import BASE_N, HAP_PAD

BLOCK = 32  # pairs per program (one warp)
BAND = 8  # read rows per register band
KERNELS = ("pallas", "xla")


def kernel_for_platform(platform: str) -> str:
    """The PairHMM forward a device runs: the Pallas kernel on a GPU,
    the XLA row scan on the CPU.  Any other platform has no path."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no PairHMM forward for platform {platform!r}")


def hap_to_mask(hap_codes):
    """hap base codes -> one-hot match masks: N matches every base, pad
    columns get 0 and never match."""
    return jnp.where(
        hap_codes >= HAP_PAD,
        0,
        jnp.where(hap_codes == BASE_N, 15, jnp.int32(1) << hap_codes),
    ).astype(jnp.int32)


def _wavefront_kernel(
    rslen_ref, haplen_ref,
    mm_ref, gapm_ref, mx_ref, xx_ref, my_ref, yy_ref, emm_ref, emx_ref,
    rs_ref, hap_ref, y0_ref,
    out_ref, scr_ref,
    *, band: int,
):
    C = band
    f32 = jnp.float32
    y0 = y0_ref[...]
    zero = jnp.zeros_like(y0)
    n_bands = (jnp.max(rslen_ref[...]) + C) // C  # rows <= max rslen, + 1
    n_cols = jnp.max(haplen_ref[...])

    # scratch position p holds column p - (C - 2); start as row -1
    def init(p, carry):
        scr_ref[0, p, :] = zero
        scr_ref[1, p, :] = zero
        scr_ref[2, p, :] = y0
        return carry

    # the carry is unused: the Triton lowering of a loop whose carry is a
    # Python constant fails ("scf.yield ... is not a Value")
    jax.lax.fori_loop(C - 2, n_cols + 2 * C - 2, init, n_cols)

    def band_body(k, acc):
        r0 = k * C
        coef = [
            [ref[r0 + r, :] for r in range(C)]
            for ref in (mm_ref, gapm_ref, mx_ref, xx_ref, my_ref, yy_ref,
                        emm_ref, emx_ref)
        ]
        mm, gapm, mx, xx, my, yy, emm, emx = coef
        rsm = []
        for r in range(C):
            rs = rs_ref[r0 + r, :]
            rsm.append(jnp.where(rs == BASE_N, 15, jnp.int32(1) << rs))
        zi = jnp.zeros(y0.shape, jnp.int32)
        # diagonal of band row 0 at column 1: the band above at column 0
        d_m = scr_ref[0, C - 2, :]
        d_s = scr_ref[1, C - 2, :] + scr_ref[2, C - 2, :]
        state = (
            (zi,) * C,  # hap mask seen by each row
            (zero,) * C, (zero,) * C, (zero,) * C,  # M, X, Y at column c
            (zero,) * C, (zero,) * C,  # M, X+Y at column c - 1
            d_m, d_s, zero,
        )

        def step(t, carry):
            hd, m_c, x_c, y_c, m_p, s_p, d_m, d_s, acc = carry
            hd = (hap_ref[t, :],) + hd[:-1]
            u_m = scr_ref[0, t + C - 1, :]
            u_x = scr_ref[1, t + C - 1, :]
            u_y = scr_ref[2, t + C - 1, :]
            m_n, x_n, y_n = [], [], []
            for r in range(C):
                if r == 0:
                    dm, ds, um, ux = d_m, d_s, u_m, u_x
                else:
                    dm, ds, um, ux = m_p[r - 1], s_p[r - 1], m_c[r - 1], x_c[r - 1]
                h = hd[r]
                distm = jnp.where((h & rsm[r]) != 0, emm[r], emx[r])
                distm = jnp.where(h == 0, f32(0), distm)
                m = distm * (mm[r] * dm + gapm[r] * ds)
                x = mx[r] * um + xx[r] * ux
                y = my[r] * m_c[r] + yy[r] * y_c[r]
                if r:  # row r reaches column 1 at step r
                    live = t >= r
                    m = jnp.where(live, m, f32(0))
                    x = jnp.where(live, x, f32(0))
                    y = jnp.where(live, y, f32(0))
                m_n.append(m)
                x_n.append(x)
                y_n.append(y)
            # band bottom row -> scratch, at column t - C + 2
            scr_ref[0, t, :] = m_n[-1]
            scr_ref[1, t, :] = x_n[-1]
            scr_ref[2, t, :] = y_n[-1]
            s_c = tuple(a + b for a, b in zip(x_c, y_c))
            return (
                hd, tuple(m_n), tuple(x_n), tuple(y_n), m_c, s_c,
                u_m, u_x + u_y, acc + x_n[-1],
            )

        out = jax.lax.fori_loop(0, n_cols + C - 1, step, state)
        return out[-1]  # X summed over the band's bottom row

    out_ref[...] = jax.lax.fori_loop(0, n_bands, band_body, zero)


@functools.partial(
    jax.jit, static_argnames=("block", "band", "interpret")
)
def pairhmm_forward_pallas(
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy,
    em_match, em_mis, rs, hap_ext, y0, rslen, haplen,
    block: int = BLOCK, band: int = BAND, interpret: bool = False,
):
    """Batched PairHMM forward via the wavefront kernel.

    Arrays as ``jax_impl.pairhmm_forward`` (time-major (R, B) planes,
    (R + H, B) hap_ext, (B,) y0) plus the (B,) read and haplotype
    lengths.  B must be a multiple of ``block`` and R of ``band``.
    Returns (B,) float32 forward probabilities.
    """
    rows, bsz = p_mm.shape
    if bsz % block:
        raise ValueError(f"batch {bsz} must be a multiple of {block}")
    if rows % band:
        raise ValueError(f"rows {rows} must be a multiple of {band}")
    f32 = jnp.float32
    n_scr = hap_ext.shape[0] - rows + 2 * band
    coef = [a.astype(f32) for a in
            (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis)]
    row_spec = pl.BlockSpec((rows, block), lambda b: (0, b))
    lane_spec = pl.BlockSpec((block,), lambda b: (b,))
    out, _ = pl.pallas_call(
        functools.partial(_wavefront_kernel, band=band),
        grid=(bsz // block,),
        in_specs=[lane_spec, lane_spec] + [row_spec] * 9 + [
            pl.BlockSpec((hap_ext.shape[0], block), lambda b: (0, b)),
            lane_spec,
        ],
        out_specs=[
            lane_spec,
            pl.BlockSpec((3, n_scr, block), lambda b: (0, 0, b)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bsz,), f32),
            jax.ShapeDtypeStruct((3, n_scr, bsz), f32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1
        ),
        interpret=interpret,
        name="pairhmm_wavefront",
    )(
        rslen.astype(jnp.int32), haplen.astype(jnp.int32), *coef,
        rs.astype(jnp.int32), hap_to_mask(hap_ext.astype(jnp.int32)),
        y0.astype(f32),
    )
    return out


def _forward(kernel, planes, rs, hap_ext, y0, rslen, haplen, interpret):
    if kernel == "pallas":
        return pairhmm_forward_pallas(
            *planes, rs, hap_ext, y0, rslen, haplen, interpret=interpret
        )
    if kernel == "xla":
        return pairhmm_forward(*planes, rs, hap_ext, y0)
    raise ValueError(f"unknown PairHMM kernel {kernel!r}")


def forward_from_pack(
    pack: PackedPairHMMBatch, kernel: str = "pallas", interpret: bool = False
):
    """Forward of a host-packed fp32 batch through ``kernel``."""
    if pack.p_mm.dtype == np.float64:
        raise ValueError("the device forward is fp32; fp64 runs on host")
    a = [jnp.asarray(v) for v in pack.arrays()]
    return _forward(
        kernel, a[:8], a[8], a[9], a[10], jnp.asarray(pack.rslen),
        jnp.asarray(pack.haplen), interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=("rows", "initial_constant", "kernel", "interpret"),
)
def pairhmm_forward_from_quals_packed(
    big, meta, rows: int, initial_constant: float,
    kernel: str = "pallas", interpret: bool = False,
):
    """Forward from the single-upload byte-plane form: ``big`` is the
    (5*rows + rows + cols, B) uint8 buffer from the native packer (5 qual
    planes + hap_ext stacked) and ``meta`` the (2, B) int32 read /
    haplotype lengths."""
    return pairhmm_forward_from_quals(
        big[0:rows], big[rows : 2 * rows], big[2 * rows : 3 * rows],
        big[3 * rows : 4 * rows], big[4 * rows : 5 * rows], big[5 * rows :],
        meta[0], meta[1], jnp.float32(initial_constant),
        kernel=kernel, interpret=interpret,
    )


def expand_quals(q, i, d, c, rs, hap_ext, rslen, haplen, initial_constant):
    """Coefficient planes from raw qual byte planes (PackedPairHMMQuals):
    returns (the 8 planes, rs codes, hap_ext codes, y0) in the layout of
    ``jax_impl.pairhmm_forward``.

    The planes are computed on the device from the uint8 quals
    (ctx.transitions/emissions, context.py:84-118, mirroring
    baseline_impl.cpp:55-90), so the host uploads about 1/8 of the bytes
    of the fp32 coefficient packing.  Absorbing rows (row >= rslen) take
    the collector values (p_mx = p_xx = 1, everything else 0).  Every
    operation is elementwise over lanes, so lane-sharded inputs expand
    on their own devices.

    The coefficients are computed, not looked up: ph2pr[q] =
    exp2(-q*log2(10)/10), and the matchToMatch table's Jacobian-log
    construction telescopes exactly (10^log10(x) = x) to p_mm =
    1 - min(1, ph2pr[i] + ph2pr[d]).  They agree with the host tables of
    ``PairHMMContext`` to <= 27 ulp / 1.6e-6 relative over the full qual
    domain, far inside the 5e-3 oracle contract; the tests compare them.
    """
    rows, bsz = q.shape
    f32 = jnp.float32
    qi = q.astype(jnp.int32) & 127
    ii = i.astype(jnp.int32) & 127
    di = d.astype(jnp.int32) & 127
    ci = c.astype(jnp.int32) & 127
    cst = jnp.float32(-np.log2(10.0) / 10.0)
    pe_q = jnp.exp2(qi.astype(f32) * cst)
    pe_i = jnp.exp2(ii.astype(f32) * cst)
    pe_d = jnp.exp2(di.astype(f32) * cst)
    pe_c = jnp.exp2(ci.astype(f32) * cst)
    p_mm = jnp.float32(1.0) - jnp.minimum(jnp.float32(1.0), pe_i + pe_d)
    one = jnp.float32(1.0)
    valid = (
        jax.lax.broadcasted_iota(jnp.int32, (rows, bsz), 0)
        < rslen[None, :].astype(jnp.int32)
    )
    zf = jnp.zeros((rows, bsz), f32)
    planes = [
        jnp.where(valid, p_mm, 0.0),
        jnp.where(valid, one - pe_c, 0.0),
        jnp.where(valid, pe_i, 1.0),
        jnp.where(valid, pe_c, 1.0),
        jnp.where(valid, pe_d, 0.0),
        jnp.where(valid, pe_c, 0.0),
        jnp.where(valid, one - pe_q, 0.0),
        jnp.where(valid, pe_q / 3.0, 0.0) + zf,
    ]
    y0 = jnp.where(
        haplen > 0, initial_constant / haplen.astype(f32), 0.0
    ).astype(f32)
    return (planes, jnp.where(valid, rs.astype(jnp.int32), 0),
            hap_ext.astype(jnp.int32), y0)


@functools.partial(jax.jit, static_argnames=("kernel", "interpret"))
def pairhmm_forward_from_quals(
    q, i, d, c, rs, hap_ext, rslen, haplen, initial_constant,
    kernel: str = "pallas",
    interpret: bool = False,
):
    """Forward pass from raw qual byte planes: :func:`expand_quals`, then
    ``kernel``'s forward."""
    planes, rs, hap_ext, y0 = expand_quals(
        q, i, d, c, rs, hap_ext, rslen, haplen, initial_constant
    )
    return _forward(kernel, planes, rs, hap_ext, y0, rslen, haplen, interpret)

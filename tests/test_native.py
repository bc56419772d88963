"""Native C++ runtime vs Python references."""

import numpy as np

from acc_genomics_tpu import native
from acc_genomics_tpu.io.synth import gen_sw_batch, gen_pairhmm_pairs
from acc_genomics_tpu.ops.smem.index import _suffix_array
from acc_genomics_tpu.ops.sw.jax_impl import sw_fill, sw_backtrack_slim
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.utils.convert import HAP_PAD

def test_sais_matches_prefix_doubling(rng):
    for n in (1, 2, 10, 500, 4000):
        text = rng.integers(0, 4, n).astype(np.uint8)
        sa_c = native.suffix_array(text)
        sa_py = _suffix_array(text)
        np.testing.assert_array_equal(sa_c, sa_py)


def test_sais_larger_alphabet(rng):
    text = rng.integers(0, 250, 3000).astype(np.uint8)
    sa = native.suffix_array(text)
    # validate sorted order directly
    for a, b in zip(sa[:-1], sa[1:]):
        sa_a = text[a:].tobytes()
        sa_b = text[b:].tobytes()
        assert sa_a < sa_b


def test_cigar_walk_matches_python(rng):
    import jax.numpy as jnp

    ref, alts = gen_sw_batch(rng, 10, ref_len=70)
    rows, cols = 80, 80
    bsz = len(alts)
    ref_tm = np.full((rows, bsz), 255, np.int32)
    alt_tm = np.full((cols, bsz), 255, np.int32)
    reflen = np.full(bsz, len(ref), np.int32)
    altlen = np.array([len(a) for a in alts], np.int32)
    for k, a in enumerate(alts):
        ref_tm[: len(ref), k] = ref
        alt_tm[: len(a), k] = a
    for strategy in range(4):
        bt, lastrow, altcol = sw_fill(
            jnp.asarray(ref_tm), jnp.asarray(alt_tm),
            jnp.asarray(reflen), jnp.asarray(altlen), strategy,
        )
        bt = np.asarray(bt).transpose(2, 0, 1)  # (B, R, C)
        lastrow = np.asarray(lastrow).T
        altcol = np.asarray(altcol).T
        got = native.cigar_walk(bt, lastrow, altcol, reflen, altlen, strategy)
        for k in range(bsz):
            want = sw_backtrack_slim(
                bt[k], lastrow[k], altcol[k], int(reflen[k]), int(altlen[k]), strategy
            )
            assert got[k] == want, (strategy, k)


def test_pairhmm_pack_matches_python(rng):
    tcs = gen_pairhmm_pairs(rng, 9, max_read_len=30, max_hap_len=50)
    ctx = PairHMMContext(np.float32)
    got = native.pairhmm_pack_native(
        tcs, 32, 56, ctx.ph2pr, ctx.match_to_match, ctx.initial_constant
    )
    arrs, rs_out, hap_ext, y0, lens, hlens = got
    # each lane against the context's own per-base tables; rows past the
    # read are absorbing (p_mx = p_xx = 1, everything else 0)
    for k, tc in enumerate(tcs):
        r, h = len(tc["rs"]), len(tc["hap"])
        want = list(ctx.transitions(tc["i"], tc["d"], tc["c"]))
        want += list(ctx.emissions(tc["q"]))
        for j, (a, w) in enumerate(zip(arrs, want)):
            np.testing.assert_array_equal(a[:r, k], w, err_msg=str(j))
            np.testing.assert_array_equal(a[r:, k], 1.0 if j in (2, 3) else 0.0)
        np.testing.assert_array_equal(rs_out[:r, k], tc["rs"])
        np.testing.assert_array_equal(hap_ext[:h, k], tc["hap"])
        assert np.all(hap_ext[h:, k] == HAP_PAD)
        np.testing.assert_allclose(y0[k], ctx.initial_constant / h, rtol=1e-6)
        assert lens[k] == r and hlens[k] == h


def test_native_pairhmm_forward_matches_oracle(rng):
    from acc_genomics_tpu import native
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_batch_oracle

    tcs = gen_pairhmm_pairs(rng, 32, max_read_len=60, max_hap_len=150)
    got = native.pairhmm_forward(tcs, np.float64)
    want = pairhmm_batch_oracle(tcs, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # f32 parity in log space (raw values scale by different
    # INITIAL_CONSTANTs: 2^120 fp32 vs 2^1020 fp64)
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext

    got32 = native.pairhmm_forward(tcs, np.float32)
    ok = got32 > np.float32(1e-28)
    l32 = np.log10(got32[ok].astype(np.float64)) - np.float64(
        PairHMMContext(np.float32).log10_initial_constant
    )
    l64 = np.log10(want[ok]) - np.float64(
        PairHMMContext(np.float64).log10_initial_constant
    )
    assert np.max(np.abs((l32 - l64) / l64)) < 5e-3

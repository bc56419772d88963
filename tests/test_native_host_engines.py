"""Native C++ host engines (SW fill+backtrack, banded extend) vs oracles.

The reference's CPU fallbacks are production AVX code
(htc-sw/intel_avx/PairWiseSW.h:41-242, the row-wise engines of
FalconSW_AVX.cpp; bwa-sw/sdaccel/smithwaterman.cpp:75-273); the native
lib plays that role here and must stay bit-identical to the NumPy
oracles, which remain the behavioural contract.
"""

import numpy as np

from acc_genomics_tpu import native
from acc_genomics_tpu.ops.extend.reference import ExtendParams, sw_extend_oracle
from acc_genomics_tpu.ops.sw.reference import SWParams, sw_align_oracle

def test_native_sw_matches_oracle_all_strategies():
    rng = np.random.default_rng(0)
    for strat in range(4):
        refs, alts = [], []
        for _ in range(12):
            rl = int(rng.integers(5, 80))
            al = int(rng.integers(5, 80))
            ref = rng.integers(0, 4, rl).astype(np.uint8)
            alt = (
                ref[:al].copy()
                if al <= rl
                else np.concatenate(
                    [ref, rng.integers(0, 4, al - rl).astype(np.uint8)]
                )
            )
            mut = rng.random(al) < 0.1
            alt[mut] = (alt[mut] + rng.integers(1, 4, mut.sum())) % 4
            refs.append(ref)
            alts.append(alt)
        got = native.sw_align_host(refs, alts, strat)
        for r, a, g in zip(refs, alts, got):
            assert g == sw_align_oracle(r, a, strat)


def test_native_sw_custom_weights():
    rng = np.random.default_rng(1)
    p = SWParams(w_match=50, w_mismatch=-10, w_open=-40, w_extend=-3)
    ref = rng.integers(0, 4, 60).astype(np.uint8)
    alt = np.concatenate([ref[10:50], rng.integers(0, 4, 6).astype(np.uint8)])
    got = native.sw_align_host([ref], [alt], 0, p)[0]
    assert got == sw_align_oracle(ref, alt, 0, params=p)


def test_native_sw_element_overflow_returns_none():
    # an insertion in the middle forces M/I/M (3 elements); cap at 2
    rng = np.random.default_rng(4)
    ref = rng.integers(0, 4, 30).astype(np.uint8)
    alt = np.concatenate([ref[:15], np.array([2, 2, 2, 2], np.uint8), ref[15:]])
    want = sw_align_oracle(ref, alt, 0)
    assert len(want[0]) > 2
    got = native.sw_align_host([ref], [alt], 0, max_elems=2)[0]
    assert got is None  # caller reruns on the oracle


def test_native_extend_matches_oracle():
    rng = np.random.default_rng(2)
    qs, ts, h0s = [], [], []
    for _ in range(60):
        ql = int(rng.integers(0, 120))
        tl = int(rng.integers(0, 150))
        q = rng.integers(0, 5, ql).astype(np.uint8)
        t = rng.integers(0, 5, tl).astype(np.uint8)
        n = min(ql, tl)
        if n:
            t[:n] = np.where(rng.random(n) < 0.9, q[:n], t[:n])
        qs.append(q)
        ts.append(t)
        h0s.append(int(rng.integers(1, 40)))
    got = native.sw_extend_host(qs, ts, h0s)
    for j, (q, t, h0) in enumerate(zip(qs, ts, h0s)):
        want = sw_extend_oracle(q, t, h0)
        for k in ("score", "qle", "tle", "gtle", "gscore", "max_off", "w"):
            assert int(got[k][j]) == want[k], (j, k)


def test_native_smem_matches_oracle():
    from acc_genomics_tpu.io.synth import (
        gen_reference_with_repeats,
        gen_smem_reads,
    )
    from acc_genomics_tpu.ops.smem.index import FMIndex
    from acc_genomics_tpu.ops.smem.reference import (
        SmemParams,
        mem_collect_intv_oracle,
    )

    rng = np.random.default_rng(5)
    genome = gen_reference_with_repeats(rng, 20_000)
    fm = FMIndex.build(genome)
    reads = gen_smem_reads(rng, genome, 24, read_len=101)
    reads += [np.full(20, 4, np.uint8), np.array([0, 1, 2, 3] * 25, np.uint8)]

    def canon(z):
        return sorted((i["x0"], i["x1"], i["s"], i["start"], i["end"]) for i in z)

    got = native.smem_collect_host(fm, reads)
    assert got is not None
    for r, g in zip(reads, got):
        assert canon(g) == canon(mem_collect_intv_oracle(fm, r))
    # custom runtime options thread through
    p = SmemParams(min_seed_len=10, split_len=15, split_width=20, max_mem_intv=50)
    got = native.smem_collect_host(fm, reads[:8], p)
    for r, g in zip(reads[:8], got):
        assert canon(g) == canon(mem_collect_intv_oracle(fm, r, p))


def test_native_extend_custom_scoring():
    rng = np.random.default_rng(3)
    p = ExtendParams(o_del=2, e_del=2, o_ins=3, e_ins=1, pen_clip=1,
                     w=10, sc_match=2, sc_mismatch=-1, sc_ambig=-1)
    q = rng.integers(0, 4, 50).astype(np.uint8)
    t = np.concatenate([q[:30], rng.integers(0, 4, 30).astype(np.uint8)])
    got = native.sw_extend_host([q], [t], [20], p)
    want = sw_extend_oracle(q, t, 20, params=p)
    for k in ("score", "qle", "tle", "gtle", "gscore", "max_off", "w"):
        assert int(got[k][0]) == want[k], k


def test_native_smem_cache_not_stale_across_indexes():
    """The probe-table cache lives on the FMIndex object: building a new
    index (whose object may reuse the freed one's address) must never
    serve the previous genome's table."""
    from acc_genomics_tpu.io.synth import gen_reference_with_repeats
    from acc_genomics_tpu.ops.smem.index import FMIndex
    from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle

    def canon(z):
        return sorted((i["x0"], i["x1"], i["s"], i["start"], i["end"]) for i in z)

    rng = np.random.default_rng(6)
    g1 = gen_reference_with_repeats(rng, 5000)
    fm1 = FMIndex.build(g1)
    r1 = g1[100:160].copy()
    assert canon(native.smem_collect_host(fm1, [r1])[0]) == canon(
        mem_collect_intv_oracle(fm1, r1)
    )
    del fm1  # free so the next build may recycle the address
    g2 = gen_reference_with_repeats(rng, 5000)
    fm2 = FMIndex.build(g2)
    r2 = g2[100:160].copy()
    assert canon(native.smem_collect_host(fm2, [r2])[0]) == canon(
        mem_collect_intv_oracle(fm2, r2)
    )

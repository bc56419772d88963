"""SW device path (XLA fill + device backtrack walker) vs the oracle."""

import numpy as np
import pytest

from acc_genomics_tpu.config import SWConfig
from acc_genomics_tpu.engine.sw_engine import SWEngine
from acc_genomics_tpu.io.synth import gen_sw_batch
from acc_genomics_tpu.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu.ops.sw.walker import SHIP_ELEMS, sw_align_batch_device


@pytest.mark.parametrize("ref_len", [40, 100])
@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_engine_device_exact(rng, strategy, ref_len):
    """Engine route per overhang strategy and bucket (64 and 128):
    exact CIGARs and offsets, with only element buffers fetched."""
    ref, alts = gen_sw_batch(rng, 10, ref_len=ref_len)
    eng = SWEngine(SWConfig(seq_buckets=(64, 128)))
    got = eng.align([ref] * len(alts), alts, strategy)
    assert eng.stats["host_fallback"] == 0 and eng.stats["device_calls"] == 1
    for a, res in zip(alts, got):
        assert res == sw_align_oracle(ref, a, strategy)


def test_sw_device_mixed_lengths(rng):
    refs, alts = [], []
    for ln in (10, 30, 44):
        r, (a,) = gen_sw_batch(rng, 1, ref_len=ln)
        refs.append(r)
        alts.append(a)
    got = sw_align_batch_device(refs, alts, 0, rows=48, cols=48)
    for r, a, res in zip(refs, alts, got):
        assert res == sw_align_oracle(r, a, 0)


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_device_tie_breaking_stress(rng, strategy):
    """Degenerate inputs with massive score ties: identical sequences,
    homopolymers, periodic repeats — the vectorized start-cell selection
    must reproduce GATK's sequential tie-break chain exactly."""
    cases = []
    ref1 = rng.integers(0, 4, 22).astype(np.uint8)
    cases.append((ref1, ref1.copy()))                      # identical
    cases.append((np.zeros(18, np.uint8), np.zeros(22, np.uint8)))  # homopolymer
    cases.append((np.zeros(22, np.uint8), np.zeros(13, np.uint8)))
    per = np.tile(np.array([0, 1], np.uint8), 11)
    cases.append((per, np.tile(np.array([0, 1], np.uint8), 9)))     # periodic
    cases.append((per, np.roll(per, 1)))                   # phase-shifted
    ref2 = rng.integers(0, 4, 12).astype(np.uint8)
    cases.append((ref2, np.concatenate([ref2, ref2])))     # tandem duplicate
    cases.append((np.concatenate([ref2, ref2]), ref2))
    refs = [r for r, _ in cases]
    alts = [a for _, a in cases]
    got = sw_align_batch_device(refs, alts, strategy, rows=32, cols=32)
    for (r, a), res in zip(cases, got):
        want = sw_align_oracle(r, a, strategy)
        assert ([tuple(e) for e in want[0]], want[1]) == (
            [tuple(e) for e in res[0]], res[1]), (strategy, r[:8], a[:8])


def test_sw_device_element_overflow_reruns_on_host(rng):
    """Pairs whose CIGAR exceeds the shipped element prefix rerun on the
    host engine (the interval-overflow contract analog)."""
    ref = rng.integers(0, 4, 96).astype(np.uint8)
    alt = []
    for j, b in enumerate(ref):
        alt.append(b)
        if j % 2 == 0:  # alternating match/insert: ~2 elements per 3 bases
            alt.append((b + 1) % 4)
            alt.append((b + 2) % 4)
    alt = np.asarray(alt, np.uint8)[:160]
    wc, wo = sw_align_oracle(ref, alt, 0)
    assert len(wc) > SHIP_ELEMS  # the premise: a genuinely long CIGAR
    got = sw_align_batch_device([ref], [alt], 0, rows=96, cols=192)
    assert got[0] == (wc, wo)


def test_sw_engine_fetches_only_element_buffers(rng):
    """The btrack matrix stays on the device: one call fetches the
    (SHIP_ELEMS + 2, B) int16 element buffers and nothing else."""
    ref, alts = gen_sw_batch(rng, 24, ref_len=100)
    eng = SWEngine(SWConfig(seq_buckets=(128,)))
    eng.align([ref] * len(alts), alts, 0)
    bsz = 32  # 24 pairs pad to the next power of two
    assert eng.stats["d2h_bytes"] == (SHIP_ELEMS + 2) * bsz * 2
    assert eng.stats["d2h_bytes"] < 128 * 128 * bsz * 2 // 100

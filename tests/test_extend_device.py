"""Extend engine on one device (fused XLA left/right extension) vs the
oracle, exact, including early exit and band edges."""

import numpy as np
import pytest

from acc_genomics_tpu.config import ExtendConfig
from acc_genomics_tpu.engine.extend_engine import ExtendEngine
from acc_genomics_tpu.ops.extend.reference import extend_seed_oracle


def _seed(genome, pos, read, qbeg, slen, flank):
    read = read.copy()
    read[qbeg : qbeg + slen] = genome[pos + qbeg : pos + qbeg + slen]
    span = genome[pos - flank : pos + len(read) + flank]
    return dict(read=read, rseq=span, qbeg=qbeg, rbeg_off=flank + qbeg,
                len=slen)


def _check(seeds, config=ExtendConfig()):
    eng = ExtendEngine(config)
    got = eng.extend_seeds(seeds)
    assert eng.stats["host_fallback"] == 0
    p = config.params()
    for s, g in zip(seeds, got):
        assert g == extend_seed_oracle(
            s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"], p
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_extend_engine_device_exact(seed):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000).astype(np.uint8)
    seeds = []
    for _ in range(40):
        pos = int(rng.integers(120, 1700))
        rl = int(rng.integers(40, 150))
        read = genome[pos : pos + rl].copy()
        err = rng.random(rl) < 0.04
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        qbeg = int(rng.integers(0, rl - 25))
        seeds.append(_seed(genome, pos, read, qbeg, int(rng.integers(19, 25)),
                           flank=100))
    _check(seeds)


def test_extend_engine_early_exit(rng):
    """Extensions that die: the read diverges completely past the seed,
    so the zero-score row breaks the scan early in both directions."""
    genome = rng.integers(0, 4, 800).astype(np.uint8)
    seeds = []
    for k in range(12):
        pos = 200 + 30 * k
        read = genome[pos : pos + 101].copy()
        qbeg = 40
        read[: qbeg - 3] = (read[: qbeg - 3] + 2) % 4  # left dies
        read[qbeg + 24 :] = (read[qbeg + 24 :] + 1 + k % 3) % 4  # right dies
        seeds.append(_seed(genome, pos, read, qbeg, 21, flank=100))
    _check(seeds)


def test_extend_engine_band_edges(rng):
    """Indels near and past the band width: with w=6 a 4-base deletion
    stays inside the band and a 10-base one falls outside it, so the
    band doubling and the band clipping both decide the result."""
    genome = rng.integers(0, 4, 1200).astype(np.uint8)
    seeds = []
    for k, gap in enumerate((2, 4, 6, 8, 10, 14)):
        pos = 150 + 150 * k
        ref = genome[pos : pos + 140]
        read = np.concatenate([ref[:90], ref[90 + gap :]])[:120].copy()
        seeds.append(_seed(genome, pos, read, 20, 25, flank=60))
        ins = rng.integers(0, 4, gap).astype(np.uint8)
        read2 = np.concatenate([ref[:80], ins, ref[80:]])[:120]
        seeds.append(_seed(genome, pos, read2, 20, 25, flank=60))
    _check(seeds, ExtendConfig(w=6))


def test_extend_engine_degenerate_spans(rng):
    """Empty left query (seed at read start), empty right query (seed at
    read end), spans clipped at the text start, and ambiguous bases."""
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    read = genome[100:180].copy()
    seeds = [
        _seed(genome, 100, read, 0, 20, flank=50),           # qbeg = 0
        _seed(genome, 100, read, 60, 20, flank=50),          # seed at end
        dict(read=genome[0:60].copy(), rseq=genome[0:90], qbeg=5,
             rbeg_off=5, len=20),                            # text start
    ]
    amb = read.copy()
    amb[30:40] = 4
    seeds.append(_seed(genome, 100, amb, 45, 20, flank=50))
    _check(seeds)

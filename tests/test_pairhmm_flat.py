"""Flat (wire-format) PairHMM ingestion path vs the dict path.

compute_pairs_flat consumes the reference's own host-interface shape —
concatenated byte streams + per-pair lengths
(pairhmm/interface/PairHMMHostInterface.cpp:175-255) — and must produce
exactly what the per-dict path produces, including bucketing, oversize
host fallback, and the fp64 underflow recompute.
"""

import numpy as np
import pytest

from acc_genomics_tpu.config import PairHMMConfig
from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu.io.synth import gen_pairhmm_pairs


def _flatten(tcs):
    cat = lambda key: (
        np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
        if tcs else np.zeros(0, np.uint8)
    )
    lens = np.array([len(t["rs"]) for t in tcs], np.int32)
    hlens = np.array([len(t["hap"]) for t in tcs], np.int32)
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), lens,
            cat("hap"), hlens)


def test_flat_matches_dict_path_portable(rng):
    tcs = gen_pairhmm_pairs(rng, 96, max_read_len=40, max_hap_len=80)
    # both paths ship byte planes and expand them on the device, so they
    # feed the forward identical coefficients
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64, 128))
    a = PairHMMEngine(cfg)
    a.min_device_cells = 0
    want = a.compute_pairs(tcs)
    b = PairHMMEngine(cfg)
    b.min_device_cells = 0
    got = b.compute_pairs_flat(*_flatten(tcs))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_flat_pallas_interpret_with_oversize(rng):
    """The full flat path (native pack + device forward + concurrent host
    fallback + flat fp64 recompute) vs the dict path, and the Pallas
    wavefront kernel (interpret mode) on the very byte planes the flat
    path uploads vs the XLA forward the CPU engine ran on them."""
    from acc_genomics_tpu import native
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu.ops.pairhmm.kernel import (
        pairhmm_forward_from_quals_packed,
    )
    from acc_genomics_tpu.utils.convert import HAP_PAD

    tcs = gen_pairhmm_pairs(rng, 40, max_read_len=30, max_hap_len=60)
    # oversize pair -> concurrent native host fallback
    big = dict(tcs[0])
    for k in ("rs", "q", "i", "d", "c"):
        big[k] = np.resize(np.asarray(tcs[0][k], np.uint8), 80)
    tcs.append(big)
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64,))
    a = PairHMMEngine(cfg)
    a.min_device_cells = 0
    want = a.compute_pairs(tcs)

    b = PairHMMEngine(cfg)
    flat = _flatten(tcs)
    got = b.compute_pairs_flat(*flat)
    assert b.stats.get("host_fallback", 0) == 1
    assert b.stats["device_calls"] >= 1
    np.testing.assert_allclose(got, want, rtol=5e-3)

    # the 40 in-bucket pairs in one 128-lane group, as the engine packs it
    rs, q, i, d, c, lens, hap, hlens = flat
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    hoffs = np.concatenate([[0], np.cumsum(hlens[:-1])]).astype(np.int64)
    g_lens, g_hlens = np.zeros(128, np.int32), np.zeros(128, np.int32)
    g_offs, g_hoffs = np.zeros(128, np.int64), np.zeros(128, np.int64)
    g_lens[:40], g_hlens[:40] = lens[:40], hlens[:40]
    g_offs[:40], g_hoffs[:40] = offs[:40], hoffs[:40]
    planes = native.pairhmm_pack_quals_flat(
        rs, q, i, d, c, g_offs, g_lens, hap, g_hoffs, g_hlens, 32, 64,
        HAP_PAD,
    )
    buf = np.concatenate(planes)
    meta = np.stack([g_lens, g_hlens])
    ic = float(PairHMMContext(np.float32).initial_constant)
    fwd = {
        kernel: np.asarray(pairhmm_forward_from_quals_packed(
            buf, meta, rows=32, initial_constant=ic, kernel=kernel,
            interpret=kernel == "pallas",
        ))
        for kernel in ("pallas", "xla")
    }
    np.testing.assert_allclose(fwd["pallas"], fwd["xla"], rtol=1e-5)
    assert np.all(fwd["pallas"][:40] > 0) and np.all(fwd["pallas"][40:] == 0)


def test_flat_stream_matches_single_calls(rng):
    tcs_batches = [
        gen_pairhmm_pairs(rng, 40, max_read_len=30, max_hap_len=60)
        for _ in range(3)
    ]
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64,))
    eng = PairHMMEngine(cfg)
    eng.min_device_cells = 0
    batches = [_flatten(t) for t in tcs_batches]
    got = eng.compute_pairs_flat_stream(batches)
    for b, g in zip(batches, got):
        eng2 = PairHMMEngine(cfg)
        eng2.min_device_cells = 0
        np.testing.assert_allclose(g, eng2.compute_pairs_flat(*b), rtol=1e-12)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_quals_expansion_matches_host_coefficients(rng, kernel):
    """Coefficient planes expanded on the device from the uploaded quality
    bytes (exp2 + the telescoped matchToMatch identity) against the host
    packer's table lookups, through the same forward: the two agree to
    <= 27 ulp per coefficient, so the likelihoods agree to ~1e-5, far
    inside the 5e-3 contract."""
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu.ops.pairhmm.kernel import (
        forward_from_pack,
        pairhmm_forward_from_quals,
    )
    from acc_genomics_tpu.ops.pairhmm.pack import (
        pack_pairhmm_batch,
        pack_pairhmm_quals,
    )

    tcs = gen_pairhmm_pairs(rng, 50, max_read_len=30, max_hap_len=60)
    interpret = kernel == "pallas"
    host = forward_from_pack(
        pack_pairhmm_batch(tcs, rows=32, cols=64, dtype=np.float32),
        kernel, interpret=interpret,
    )
    qp = pack_pairhmm_quals(tcs, rows=32, cols=64)
    dev = pairhmm_forward_from_quals(
        qp.q, qp.i, qp.d, qp.c, qp.rs, qp.hap_ext, qp.rslen, qp.haplen,
        np.float32(PairHMMContext(np.float32).initial_constant),
        kernel=kernel, interpret=interpret,
    )
    host, dev = np.asarray(host)[:50], np.asarray(dev)[:50]
    assert np.all(host > 0)
    np.testing.assert_allclose(np.log10(dev), np.log10(host), rtol=2e-4)

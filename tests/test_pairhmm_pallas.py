"""Pallas wavefront kernel vs oracle (interpret mode on CPU)."""

import numpy as np

from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.kernel import forward_from_pack
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle


def _oracle_logs(tcs):
    return np.array(
        [
            pairhmm_loglik_oracle(
                tc["rs"], tc["q"], tc["i"], tc["d"], tc["c"], tc["hap"], np.float64
            )
            for tc in tcs
        ]
    )


def _kernel_logs(pack):
    res = np.asarray(forward_from_pack(pack, "pallas", interpret=True))
    ctx = PairHMMContext(np.float32)
    return np.log10(res.astype(np.float64)) - np.float64(ctx.log10_initial_constant)


def test_pallas_kernel_matches_oracle(rng):
    tcs = gen_pairhmm_pairs(rng, 128, max_read_len=15, max_hap_len=24)
    pack = pack_pairhmm_batch(tcs, rows=16, cols=24, dtype=np.float32)
    np.testing.assert_allclose(_kernel_logs(pack), _oracle_logs(tcs), rtol=5e-3)


def test_pallas_kernel_mixed_lengths_with_n(rng):
    tcs = gen_pairhmm_pairs(rng, 120, max_read_len=23, max_hap_len=30)
    tcs += gen_pairhmm_pairs(rng, 8, max_read_len=3, max_hap_len=5)
    for t in tcs[::9]:
        t["rs"][::6] = 4
        t["hap"][::5] = 4
    pack = pack_pairhmm_batch(tcs, rows=24, cols=32, dtype=np.float32)
    np.testing.assert_allclose(_kernel_logs(pack), _oracle_logs(tcs), rtol=5e-3)


def test_pallas_batch_not_multiple_of_lanes(rng):
    tcs = gen_pairhmm_pairs(rng, 5, max_read_len=7, max_hap_len=9)
    pack = pack_pairhmm_batch(tcs, rows=8, cols=16, dtype=np.float32, pad_lanes=False)
    try:
        forward_from_pack(pack, "pallas", interpret=True)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "multiple of 32" in str(e)


def test_packer_lane_padding_inert(rng):
    # 5 real pairs padded to 128 lanes: padded lanes produce 0
    tcs = gen_pairhmm_pairs(rng, 5, max_read_len=7, max_hap_len=9)
    pack = pack_pairhmm_batch(tcs, rows=8, cols=16, dtype=np.float32)
    assert pack.batch == 128 and pack.n_real == 5
    res = np.asarray(forward_from_pack(pack, "pallas", interpret=True))
    assert np.all(res[5:] == 0.0)
    assert np.all(res[:5] > 0.0)


def test_pallas_sorted_pack_block_diags(rng):
    """Sorted packing + per-block trip counts (each block of 32 lanes
    runs only its own longest read and haplotype) == input order."""
    tcs = gen_pairhmm_pairs(rng, 260, max_read_len=15, max_hap_len=30)
    pack = pack_pairhmm_batch(
        tcs, rows=16, cols=32, dtype=np.float32, sort_by_haplen=True
    )
    assert pack.perm is not None and pack.batch == 384
    # blocks are tight: the first block's longest haplotype >= the last's
    hl = pack.haplen.reshape(-1, 32).max(axis=1)
    assert hl[0] >= hl[-1] and hl[-1] == 0  # the tail blocks are padding
    res = np.asarray(forward_from_pack(pack, "pallas", interpret=True))
    got = pack.unsort(res)
    want_logs = _oracle_logs(tcs)
    ctx = PairHMMContext(np.float32)
    got_logs = np.log10(got.astype(np.float64)) - np.float64(
        ctx.log10_initial_constant
    )
    assert np.max(np.abs((got_logs - want_logs) / want_logs)) < 5e-3


def test_pallas_from_quals_matches_oracle(rng):
    # byte-plane upload path: device-side coefficient computation
    import numpy as np
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu.ops.pairhmm.kernel import pairhmm_forward_from_quals
    from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_quals
    from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle

    tcs = gen_pairhmm_pairs(rng, 24, max_read_len=46, max_hap_len=96)
    pack = pack_pairhmm_quals(tcs, rows=48, cols=96, sort_by_haplen=True)
    ctx = PairHMMContext(np.float32)
    res = pairhmm_forward_from_quals(
        pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext,
        pack.rslen, pack.haplen,
        np.float32(ctx.initial_constant),
        kernel="pallas",
        interpret=True,
    )
    got = pack.unsort(np.asarray(res))
    ic_log = np.log10(np.float64(ctx.initial_constant))
    for k, t in enumerate(tcs):
        want = pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
        if got[k] > 0:  # fp32 path succeeded
            gl = np.log10(np.float64(got[k])) - ic_log
            assert abs(gl - want) / abs(want) < 5e-3, (k, gl, want)

"""Concurrent host-device hybrid dispatch: mixed oversize/normal batches.

The reference worker runs its CPU region on a thread while the device
processes tiles (PairHMMWorker.cpp:201-270); these tests pin that a
mixed batch (a) completes, (b) routes the oversize items through the
host fallback, and (c) every result — device or host — matches the
oracle exactly.
"""

import numpy as np

from acc_genomics_tpu.config import ExtendConfig, PairHMMConfig, SWConfig
from acc_genomics_tpu.engine.extend_engine import ExtendEngine
from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu.engine.sw_engine import SWEngine
from acc_genomics_tpu.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_oracle
from acc_genomics_tpu.ops.sw.reference import sw_align_oracle


def test_sw_mixed_oversize_batch():
    rng = np.random.default_rng(0)
    cfg = SWConfig(seq_buckets=(64, 128))  # force len > 128 to host
    eng = SWEngine(cfg)
    refs, alts = [], []
    for k in range(8):
        rl = 200 if k % 3 == 0 else 50  # every 3rd pair oversize
        ref = rng.integers(0, 4, rl).astype(np.uint8)
        alt = ref[: rl - 10].copy()
        mut = rng.random(len(alt)) < 0.1
        alt[mut] = (alt[mut] + rng.integers(1, 4, mut.sum())) % 4
        refs.append(ref)
        alts.append(alt)
    got = eng.align(refs, alts, 0)
    assert eng.stats["host_fallback"] == 3
    for r, a, g in zip(refs, alts, got):
        assert g == sw_align_oracle(r, a, 0)


def test_extend_mixed_oversize_batch():
    rng = np.random.default_rng(1)
    cfg = ExtendConfig(max_qlen=64, max_tlen=128)
    eng = ExtendEngine(cfg)
    seeds = []
    for k in range(6):
        rl = 150 if k % 2 == 0 else 40  # right-extension query oversize
        read = rng.integers(0, 4, rl).astype(np.uint8)
        rseq = np.concatenate(
            [rng.integers(0, 4, 5).astype(np.uint8), read,
             rng.integers(0, 4, 5).astype(np.uint8)]
        )
        seeds.append(dict(read=read, rseq=rseq, qbeg=5, rbeg_off=10, len=15))
    got = eng.extend_seeds(seeds)
    assert eng.stats["host_fallback"] > 0
    for s, g in zip(seeds, got):
        assert g == extend_seed_oracle(
            s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"]
        )


def test_pairhmm_mixed_oversize_batch():
    rng = np.random.default_rng(2)
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(128,))
    eng = PairHMMEngine(cfg)
    eng.min_device_cells = 0  # force the device path for in-bucket pairs
    tcs = []
    for k in range(6):
        ln = 100 if k % 3 == 0 else 40  # oversize read every 3rd pair
        hl = 100
        hap = rng.integers(0, 4, hl).astype(np.uint8)
        rs = hap[:ln].copy() if ln <= hl else np.resize(hap, ln).copy()
        tcs.append(
            dict(
                rs=rs,
                q=np.clip(rng.normal(30, 5, ln), 6, 127).astype(np.uint8),
                i=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                d=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                c=np.full(ln, 10, np.uint8),
                hap=hap,
            )
        )
    got = eng.compute_pairs(tcs)
    assert eng.stats.get("host_fallback", 0) == 2
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext

    ctx64 = PairHMMContext(np.float64)
    for t, g in zip(tcs, got):
        want64 = pairhmm_oracle(
            t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"], np.float64
        )
        want = np.log10(want64) - ctx64.log10_initial_constant
        assert abs(g - want) <= 5e-3 * max(abs(want), 1e-12)


def test_pairhmm_oversize_hap_routes_to_sp_on_mesh():
    """On a ("data","seq") mesh, a hap beyond the bucket cap runs on the
    DP x SP shard (collectives over "seq"), not the host oracle — the
    reference segments oversized haps instead (PairHMMFpga.cpp:284-332)."""
    import jax

    from acc_genomics_tpu.parallel import make_mesh

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh((4, 2))
    rng = np.random.default_rng(5)
    cfg = PairHMMConfig(read_buckets=(32,), hap_buckets=(64,))
    eng = PairHMMEngine(cfg, mesh=mesh)
    eng.min_device_cells = 0
    tcs = []
    for hl in (50, 100, 120):  # 100/120 exceed the 64-column bucket
        ln = 30
        hap = rng.integers(0, 4, hl).astype(np.uint8)
        rs = np.resize(hap, ln).copy()
        tcs.append(
            dict(
                rs=rs,
                q=np.clip(rng.normal(30, 5, ln), 6, 127).astype(np.uint8),
                i=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                d=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                c=np.full(ln, 10, np.uint8),
                hap=hap,
            )
        )
    got = eng.compute_pairs(tcs)
    assert eng.stats.get("sp_pairs", 0) == 2
    assert eng.stats.get("host_fallback", 0) == 0
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext

    ctx64 = PairHMMContext(np.float64)
    for t, g in zip(tcs, got):
        want64 = pairhmm_oracle(
            t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"], np.float64
        )
        want = np.log10(want64) - ctx64.log10_initial_constant
        assert abs(g - want) <= 5e-3 * max(abs(want), 1e-12)


def test_pairhmm_oversize_hap_sp_pallas_on_mesh():
    """Same SP routing, with the wavefront kernel as the per-shard body of
    the in-bucket DP launch as a GPU mesh runs it: oversized haps take the
    XLA DP x SP path, the engine's own in-bucket pack through the Pallas
    kernel (interpret mode on the CPU mesh) agrees with the engine's
    answer, and all match the fp64 oracle within contract."""
    import jax

    from acc_genomics_tpu.ops.pairhmm.pack import LANES, pack_pairhmm_batch
    from acc_genomics_tpu.parallel import make_mesh, pairhmm_forward_dp
    from acc_genomics_tpu.parallel.sharded import shard_lanes

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh((4, 2))
    rng = np.random.default_rng(6)
    cfg = PairHMMConfig(read_buckets=(32,), hap_buckets=(64,))
    eng = PairHMMEngine(cfg, mesh=mesh)
    eng.min_device_cells = 0
    tcs = []
    for hl in (50, 100, 120):  # 100/120 exceed the 64-column bucket
        ln = 30
        hap = rng.integers(0, 4, hl).astype(np.uint8)
        rs = np.resize(hap, ln).copy()
        tcs.append(
            dict(
                rs=rs,
                q=np.clip(rng.normal(30, 5, ln), 6, 127).astype(np.uint8),
                i=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                d=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
                c=np.full(ln, 10, np.uint8),
                hap=hap,
            )
        )
    got = eng.compute_pairs(tcs)
    assert eng.stats.get("sp_pairs", 0) == 2
    assert eng.stats.get("host_fallback", 0) == 0
    assert eng.stats["device_calls"] == 1  # the in-bucket DP launch
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext

    pack = pack_pairhmm_batch(
        tcs[:1], rows=32, cols=64, dtype=np.float32, sort_by_haplen=True,
        lane_multiple=LANES * 4,
    )
    args = shard_lanes(mesh, list(pack.arrays()) + [pack.rslen, pack.haplen])
    raw = pack.unsort(np.asarray(pairhmm_forward_dp(
        mesh, *args[:11], rslen=args[11], haplen=args[12], kernel="pallas",
        interpret=True,
    )))
    pallas_log = np.log10(np.float64(raw[0])) - np.float64(
        PairHMMContext(np.float32).log10_initial_constant
    )
    assert abs(pallas_log - got[0]) <= 1e-5 * abs(got[0])
    ctx64 = PairHMMContext(np.float64)
    for t, g in zip(tcs, got):
        want64 = pairhmm_oracle(
            t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"], np.float64
        )
        want = np.log10(want64) - ctx64.log10_initial_constant
        assert abs(g - want) <= 5e-3 * max(abs(want), 1e-12)


def test_calibrated_dispatch_crossover_moves_with_constants():
    """The calibrated gate (DispatchCostModel, the worthFPGA analog)
    must flip host<->device as the measured constants move — a fast-host
    model routes mid-size batches to the host, a fast-link/low-latency
    model routes them to the device, and for FIXED constants the
    decision flips from host to device as the batch grows past the
    crossover."""
    from acc_genomics_tpu.engine.pairhmm_engine import DispatchCostModel

    cells, nbytes = 5_000_000, 130_000
    many_core_host = DispatchCostModel(
        host_gcups=0.35, device_gcups=55, link_gb_s=0.05, fixed_s=0.06,
        cores=24,
    )
    pcie_device = DispatchCostModel(
        host_gcups=0.35, device_gcups=55, link_gb_s=12.0, fixed_s=0.001,
        cores=1,
    )
    assert not many_core_host.device_worthwhile(cells, nbytes)
    assert pcie_device.device_worthwhile(cells, nbytes)
    # fixed constants: the crossover exists and is ordered in batch size
    m = DispatchCostModel(
        host_gcups=0.35, device_gcups=55, link_gb_s=1.0, fixed_s=0.06,
        cores=1,
    )
    assert not m.device_worthwhile(1_000_000, 25_000)
    assert m.device_worthwhile(400_000_000, 10_000_000)
    # and it moves when the host gets faster: the same big batch stays
    # on a 100x-faster host
    fast = DispatchCostModel(
        host_gcups=35.0, device_gcups=55, link_gb_s=1.0, fixed_s=0.06,
        cores=1,
    )
    assert not fast.device_worthwhile(400_000_000, 10_000_000)


def test_calibrated_dispatch_engine_routing():
    """Engine-level: installing opposite cost models routes the SAME
    batch to host vs device, both oracle-exact."""
    from acc_genomics_tpu.engine.pairhmm_engine import DispatchCostModel
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs

    rng = np.random.default_rng(3)
    tcs = gen_pairhmm_pairs(rng, 12, max_read_len=40, max_hap_len=90)
    from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle

    want = np.array([
        pairhmm_loglik_oracle(
            t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"]
        )
        for t in tcs
    ])

    eng = PairHMMEngine()
    eng.set_cost_model(DispatchCostModel(
        host_gcups=100.0, device_gcups=1e-3, fixed_s=10.0, link_gb_s=1e-4,
    ))
    got = eng.compute_pairs(tcs)
    assert eng.stats.get("host_native_calls", 0) == 1
    np.testing.assert_allclose(got, want, rtol=5e-3)

    eng2 = PairHMMEngine()
    eng2.set_cost_model(DispatchCostModel(
        host_gcups=1e-4, device_gcups=100.0, fixed_s=0.0, link_gb_s=100.0,
    ))
    got2 = eng2.compute_pairs(tcs)
    assert eng2.stats.get("host_native_calls", 0) == 0
    assert eng2.stats["device_calls"] >= 1
    np.testing.assert_allclose(got2, want, rtol=5e-3)

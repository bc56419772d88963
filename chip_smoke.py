#!/usr/bin/env python
"""Smoke test of the genomics engine on an NVIDIA GPU.

Drives the two consumer pipelines once through their normal entry
points, at the repository's bench sizes, and checks every result against
the NumPy oracles of ``ops/*/reference.py`` (SMEM, SW and extend
exactly; PairHMM within 5e-3 relative of the fp64 oracle):

  0. set-up: a GPU is required; the native library is built with make
  1. PairHMM engine, flat path: 8192 pairs, reads <= 151, haps <= 384
  2. SW engine: 8192 pairs against a 286 bp reference, four overhang
     strategies; the backtrack matrix stays on the device
  3. HaplotypeCaller regions: 64 regions of 24 reads
  4. BWA-MEM at 100 Mbp: index build, 2048 reads mapped by the device
     pipeline, and 8 x 65536 reads through the multi-read SMEM machine
  5. memory: every compiled program's memory analysis, peak bytes

Every phase prints one line with its time per call and rate and the
card's name and power limit.  The last line of standard output is one
JSON object, ``{"ok": true, "device": {...}}``; a failed phase raises
and the script exits non-zero.  Data is made from ``--seed``.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the mesh paths, against one card
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse [--four-cards]

``--rehearse`` runs the same phases at toy sizes on whatever device JAX
has (the CPU here), to find wrong paths before a run on the card; it
prints no result line and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FULL = dict(
    ph_pairs=8192, ph_read=151, ph_hap=384, ph_check=320,
    sw_pairs=8192, sw_ref=286, sw_check=64,
    hc_regions=64, hc_reads=24, hc_check=4,
    genome=100_000_000, bwa_reads=2048, bwa_check=256,
    smem_reads=8 * 65536, smem_check=64,
    # four cards: the mesh paths at widths that fill each card's shard
    mc_genome=10_000_000, mc_smem_reads=2 * 65536, mc_seeds=8192,
    mc_sp_pairs=256,
)
TOY = dict(
    ph_pairs=96, ph_read=80, ph_hap=80, ph_check=24,
    sw_pairs=24, sw_ref=60, sw_check=6,
    hc_regions=3, hc_reads=4, hc_check=2,
    genome=20_000, bwa_reads=16, bwa_check=16,
    smem_reads=3 * 16, smem_check=8,
    mc_genome=20_000, mc_smem_reads=2 * 16, mc_seeds=32,
    mc_sp_pairs=8,
)

CARD = "not measured"


def say(phase: str, **kv) -> None:
    """One result line: the phase, its numbers, the card they came from."""
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body} | {CARD}", flush=True)


def timed(fn, reps: int = 2):
    """(first-call seconds, best steady seconds, last result).  Every
    engine entry point returns host arrays, so each call has ended on
    the device when it returns."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def device_busy(fn):
    """Device busy ms and idle share of one traced call."""
    from acc_genomics_tpu.utils.devtrace import device_time

    tr = device_time(fn)
    idle = 1.0 - tr["busy_ms"] / max(tr["host_ms"], 1e-9)
    return tr["busy_ms"], idle, tr


def flatten_pairs(tcs):
    cat = lambda k: np.concatenate([np.asarray(t[k], np.uint8) for t in tcs])
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(t["rs"]) for t in tcs], np.int32), cat("hap"),
            np.array([len(t["hap"]) for t in tcs], np.int32))


def oracle_loglik(t):
    from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle

    return pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"],
                                 t["hap"])


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.abs(want), initial=0.0))


def make_reads(rng, genome, n, read_len=101, error_rate=0.01,
               ambig_rate=0.002):
    """(L=128, n) uint8 time-major reads sampled from ``genome`` with
    point errors and Ns: gen_smem_reads' model, drawn in bulk."""
    pos = rng.integers(0, len(genome) - read_len, n)
    reads = genome[pos[:, None] + np.arange(read_len)[None, :]]
    err = rng.random(reads.shape) < error_rate
    reads = np.where(err, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    reads[rng.random(reads.shape) < ambig_rate] = 4
    seq_tm = np.full((128, n), 4, np.uint8)
    seq_tm[:read_len] = reads.T
    return seq_tm, np.full(n, read_len, np.int32)


def canon_arrays(mem, mem_n, k):
    return sorted(tuple(int(v) for v in mem[:, j, k])
                  for j in range(int(mem_n[k])))


def canon_dicts(ivs):
    return sorted((i["x0"], i["x1"], i["s"], i["start"], i["end"])
                  for i in ivs)


# ---------------------------------------------------------------- phases


def phase_pairhmm(rng, S):
    from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext

    tcs = gen_pairhmm_pairs(rng, S["ph_pairs"], max_read_len=S["ph_read"],
                            max_hap_len=S["ph_hap"])
    flat = flatten_pairs(tcs)
    cells = int((flat[5].astype(np.int64) * flat[7]).sum())
    eng = PairHMMEngine()
    first, best, out = timed(lambda: eng.compute_pairs_flat(*flat))
    busy, idle, _ = device_busy(lambda: eng.compute_pairs_flat(*flat))
    assert eng.stats["device_calls"] > 0, eng.stats
    assert eng.stats.get("host_fallback", 0) == 0, eng.stats
    assert eng.stats.get("host_native_calls", 0) == 0, eng.stats
    assert out.shape == (len(tcs),) and np.isfinite(out).all()
    # oracle sample: random pairs with short reads stay above the fp32
    # floor (answered by the device); most long ones underflow and are
    # recomputed in fp64 on the host
    short = np.flatnonzero(flat[5] <= 60)
    n_dev = S["ph_check"] * 4 // 5
    idx = np.concatenate([
        rng.choice(short, n_dev, replace=False),
        rng.choice(np.setdiff1d(np.arange(len(tcs)), short),
                   S["ph_check"] - n_dev, replace=False),
    ])
    want = np.array([oracle_loglik(tcs[k]) for k in idx])
    log_ic = np.log10(PairHMMContext(np.float32).initial_constant)
    device_answered = int(np.sum(want + log_ic > np.log10(2e-28)))
    assert device_answered >= n_dev, device_answered
    err = rel_err(out[idx], want)
    assert err < 5e-3, err
    calls = 4  # timed() made 3 calls, device_busy one
    say("pairhmm", kernel=eng.kernel, pairs=len(tcs), cells=cells,
        first_call_s=round(first, 3), ms_per_call=round(best * 1e3, 3),
        gcups=round(cells / best / 1e9, 3),
        device_busy_ms=round(busy, 3), idle_share=round(idle, 3),
        recomputed_fp64_per_call=eng.stats["recomputed"] // calls,
        checked=len(idx), device_answered_checked=device_answered,
        max_rel_err=f"{err:.2e}")


def phase_sw(rng, S):
    from acc_genomics_tpu.config import SWConfig
    from acc_genomics_tpu.engine.sw_engine import SWEngine
    from acc_genomics_tpu.io.synth import gen_sw_batch
    from acc_genomics_tpu.ops.sw.reference import sw_align_oracle
    from acc_genomics_tpu.ops.sw.walker import SHIP_ELEMS

    ref, alts = gen_sw_batch(rng, S["sw_pairs"], ref_len=S["sw_ref"])
    refs = [ref] * len(alts)
    cells = sum(len(ref) * len(a) for a in alts)
    eng = SWEngine()
    bucket = next(b for b in SWConfig().seq_buckets
                  if b >= max(len(ref), max(len(a) for a in alts)))
    for strategy in range(4):
        first, best, out = timed(lambda: eng.align(refs, alts, strategy))
        d0, c0 = eng.stats["d2h_bytes"], eng.stats["device_calls"]
        busy, idle, _ = device_busy(lambda: eng.align(refs, alts, strategy))
        d2h = eng.stats["d2h_bytes"] - d0
        launches = eng.stats["device_calls"] - c0
        btrack = 2 * bucket * bucket * len(alts)  # int16 (R, C, B)
        assert eng.stats["host_fallback"] == 0, eng.stats
        assert eng.stats["walk_overflow"] == 0, eng.stats
        # the only fetch is the int16 element buffers, one column per lane
        lanes, rem = divmod(d2h, 2 * (SHIP_ELEMS + 2))
        assert rem == 0 and len(alts) <= lanes < 2 * len(alts) + 8, d2h
        idx = rng.choice(len(alts), S["sw_check"], replace=False)
        for k in idx:
            want = sw_align_oracle(ref, alts[k], strategy)
            assert out[k] == want, (strategy, k, out[k], want)
        say(f"sw.strategy{strategy}", pairs=len(alts), bucket=bucket,
            launches=launches, first_call_s=round(first, 3),
            ms_per_call=round(best * 1e3, 3),
            gcups=round(cells / best / 1e9, 3),
            device_busy_ms=round(busy, 3), idle_share=round(idle, 3),
            d2h_bytes=d2h, btrack_bytes_kept_on_device=btrack,
            walk_overflow=eng.stats["walk_overflow"], checked=len(idx))


def phase_hc(rng, S):
    from drivers.hc_driver import gen_region
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.models.haplotype_caller import HaplotypeCallerCore
    from acc_genomics_tpu.ops.sw.reference import sw_align_oracle

    regions = [gen_region(rng, n_reads=S["hc_reads"])[:3]
               for _ in range(S["hc_regions"])]
    engine = GenomicsEngine()
    hc = HaplotypeCallerCore(engine)
    t0 = time.perf_counter()
    hc.process_regions(regions)
    first = time.perf_counter() - t0
    hc.reset_anatomy()
    _, best, res = timed(lambda: hc.process_regions(regions), reps=1)
    split = {k: round(v / 2 * 1e3, 3) for k, v in hc.anatomy.items()}
    busy, idle, _ = device_busy(lambda: hc.process_regions(regions))
    assert engine.pairhmm.stats.get("host_fallback", 0) == 0
    assert engine.sw.stats["host_fallback"] == 0
    assert engine.sw.stats["walk_overflow"] == 0
    worst = 0.0
    for k in rng.choice(len(regions), S["hc_check"], replace=False):
        ref_win, haps, reads = regions[k]
        for h, got in zip(haps, res[k].hap_cigars):
            assert got == sw_align_oracle(ref_win, h, hc.overhang_strategy)
        want = np.array([[oracle_loglik(dict(hap=h, **r)) for h in haps]
                         for r in reads])
        assert res[k].likelihoods.shape == want.shape
        worst = max(worst, rel_err(res[k].likelihoods, want))
    assert worst < 5e-3, worst
    say("hc", regions=len(regions), reads_per_region=S["hc_reads"],
        first_call_s=round(first, 3), ms_per_call=round(best * 1e3, 3),
        regions_per_s=round(len(regions) / best, 1),
        device_busy_ms=round(busy, 3), idle_share=round(idle, 3),
        steady_phase_ms=split, walk_overflow=engine.sw.stats["walk_overflow"],
        checked_regions=S["hc_check"], max_rel_err=f"{worst:.2e}")


def phase_bwamem(rng, S):
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.io.synth import gen_reference_with_repeats
    from acc_genomics_tpu.models.bwa_mem import BwaMemDevicePipeline
    from acc_genomics_tpu.ops.extend.reference import extend_seed_oracle
    from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle

    t0 = time.perf_counter()
    genome = gen_reference_with_repeats(rng, S["genome"])
    engine = GenomicsEngine()
    fm = engine.load_reference(genome)
    pipe = BwaMemDevicePipeline(engine, max_occ=4, flank=100)
    build_s = time.perf_counter() - t0
    say("bwamem.setup", genome_bp=S["genome"], index_entries=fm.seq_len,
        index_build_and_upload_s=round(build_s, 3))

    # -- BWA-MEM device pipeline: seeding + fused extension
    seq_tm, lens = make_reads(rng, genome, S["bwa_reads"])
    reads = [seq_tm[: lens[k], k].copy() for k in range(len(lens))]
    first, best, out = timed(lambda: pipe.map_reads_arrays(reads))
    busy, idle, _ = device_busy(lambda: pipe.map_reads_arrays(reads))
    hits, rid, (qbeg, slen, _), host_idx = out
    assert hits.shape[1] > 0 and not host_idx, (hits.shape, host_idx)
    params = engine.extend.config.params()
    idx = rng.choice(hits.shape[1], min(S["bwa_check"], hits.shape[1]),
                     replace=False)
    for t in idx:
        read, pos = reads[rid[t]], int(hits[7, t])
        qb, sl = int(qbeg[t]), int(slen[t])
        assert np.array_equal(fm.text[pos : pos + sl], read[qb : qb + sl])
        lo = max(0, pos - qb - pipe.flank)
        hi = min(fm.seq_len, pos + sl + (len(read) - qb - sl) + pipe.flank)
        w = extend_seed_oracle(read, fm.text[lo:hi], qb, pos - lo, sl, params)
        got = hits[:7, t].tolist()
        assert got == [w["qBeg"], w["qEnd"], w["rBeg"], w["rEnd"],
                       w["score"], w["trueScore"], w["width"]], (t, got, w)
    say("bwamem.map", reads=len(reads), seeds=hits.shape[1],
        first_call_s=round(first, 3), ms_per_call=round(best * 1e3, 3),
        reads_per_s=round(len(reads) / best, 1),
        device_busy_ms=round(busy, 3), idle_share=round(idle, 3),
        checked_seeds=len(idx))

    # -- SMEM multi-read machine at the engine's default lanes
    seq_tm, lens = make_reads(rng, genome, S["smem_reads"])
    smem = engine.smem
    first, best, (mem, mem_n, ovf) = timed(
        lambda: smem.collect_arrays(seq_tm, lens), reps=1)
    it0 = smem.stats["probe_iters"]
    busy, idle, _ = device_busy(lambda: smem.collect_arrays(seq_tm, lens))
    iters = smem.stats["probe_iters"] - it0
    assert ovf.mean() < 0.01, ovf.mean()
    ok = np.flatnonzero(~ovf)
    idx = rng.choice(ok, S["smem_check"], replace=False)
    for k in idx:
        want = mem_collect_intv_oracle(fm, seq_tm[: lens[k], k], smem.params)
        assert canon_arrays(mem, mem_n, k) == canon_dicts(want), k
    say("smem.multi", reads=len(lens),
        lanes=smem.config.batch_size,
        reads_per_lane=-(-len(lens) // smem.config.batch_size),
        first_call_s=round(first, 3), ms_per_call=round(best * 1e3, 3),
        reads_per_s=round(len(lens) / best, 1),
        device_busy_ms=round(busy, 3), idle_share=round(idle, 3),
        machine_steps=iters,
        us_per_machine_step=round(busy * 1e3 / max(iters, 1), 3),
        host_rerun_reads=int(ovf.sum()), checked=len(idx))


# ------------------------------------------------------------ four cards


def phase_four_cards(rng, S):
    """The data-parallel mesh paths on four devices, each against the
    one-device result of the same inputs."""
    import jax

    from acc_genomics_tpu.config import PairHMMConfig, SmemConfig
    from acc_genomics_tpu.engine.extend_engine import ExtendEngine
    from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu.engine.smem_engine import SmemEngine
    from acc_genomics_tpu.engine.sw_engine import SWEngine
    from acc_genomics_tpu.io.synth import (
        gen_pairhmm_pairs,
        gen_reference_with_repeats,
        gen_sw_batch,
    )
    from acc_genomics_tpu.ops.smem.index import FMIndex
    from acc_genomics_tpu.parallel import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh41, mesh22 = make_mesh((4, 1)), make_mesh((2, 2))
    one = devs[0]

    # PairHMM DP (4, 1): the mesh engine against one card
    tcs = gen_pairhmm_pairs(rng, S["ph_pairs"], max_read_len=S["ph_read"],
                            max_hap_len=S["ph_hap"])
    e1 = PairHMMEngine(device=one)
    e4 = PairHMMEngine(mesh=mesh41)
    e1.min_device_cells = e4.min_device_cells = 0
    want = e1.compute_pairs(tcs)
    t0 = time.perf_counter()
    got = e4.compute_pairs(tcs)
    err = rel_err(got, want)
    assert err < 1e-4 and e4.stats["device_calls"] > 0, err
    say("4cards.pairhmm_dp", mesh="4x1", kernel=e4.kernel, pairs=len(tcs),
        s=round(time.perf_counter() - t0, 3), max_rel_diff=f"{err:.2e}")

    # PairHMM DP x SP (2, 2): haplotypes past the largest bucket run the
    # XLA sequence-parallel scan; one card runs them on the host engine
    cfg = PairHMMConfig(hap_buckets=(128, 256))
    sp = gen_pairhmm_pairs(rng, S["mc_sp_pairs"], max_read_len=60,
                           max_hap_len=2 * cfg.max_hap_len)
    e1 = PairHMMEngine(cfg, device=one)
    e4 = PairHMMEngine(cfg, mesh=mesh22)
    e1.min_device_cells = e4.min_device_cells = 0
    want = e1.compute_pairs(sp)
    got = e4.compute_pairs(sp)
    err = rel_err(got, want)
    assert e4.stats.get("sp_pairs", 0) > 0 and err < 5e-3, (e4.stats, err)
    say("4cards.pairhmm_dpsp", mesh="2x2", pairs=len(sp),
        sp_pairs=e4.stats["sp_pairs"], max_rel_diff=f"{err:.2e}")

    # SMEM multi-read DP: index replicated, lanes sharded
    genome = gen_reference_with_repeats(rng, S["mc_genome"])
    fm = FMIndex.build(genome)
    lanes = S["mc_smem_reads"] // 2
    cfg = SmemConfig(batch_size=lanes)
    seq_tm, lens = make_reads(rng, genome, S["mc_smem_reads"])
    m1 = SmemEngine(fm, cfg, device=one).collect_arrays(seq_tm, lens)
    t0 = time.perf_counter()
    m4 = SmemEngine(fm, cfg, mesh=mesh41).collect_arrays(seq_tm, lens)
    for a, b in zip(m1, m4):
        assert np.array_equal(a, b)
    say("4cards.smem_multi_dp", mesh="4x1", reads=len(lens),
        reads_per_lane=2, s=round(time.perf_counter() - t0, 3),
        identical=True)

    # extend DP: seeds from the same reads against the genome
    seeds = []
    for k in range(S["mc_seeds"]):
        pos = int(rng.integers(200, len(genome) - 400))
        read = genome[pos : pos + 101].copy()
        err_m = rng.random(101) < 0.04
        read[err_m] = (read[err_m] + rng.integers(1, 4, err_m.sum())) % 4
        qb = int(rng.integers(5, 70))
        sl = int(rng.integers(19, 25))
        read[qb : qb + sl] = genome[pos + qb : pos + qb + sl]
        seeds.append(dict(read=read, rseq=genome[pos - 150 : pos + 251],
                          qbeg=qb, rbeg_off=150 + qb, len=sl))
    x1 = ExtendEngine(device=one).extend_seeds(seeds)
    x4 = ExtendEngine(mesh=mesh41).extend_seeds(seeds)
    assert x1 == x4
    say("4cards.extend_dp", mesh="4x1", seeds=len(seeds), identical=True)

    # SW device DP: fill + walker per shard, element buffers gathered
    ref, alts = gen_sw_batch(rng, S["sw_pairs"], ref_len=S["sw_ref"])
    refs = [ref] * len(alts)
    for strategy in (0, 2):  # soft-clip and leading-indel start rules
        s1 = SWEngine(device=one).align(refs, alts, strategy)
        s4 = SWEngine(mesh=mesh41).align(refs, alts, strategy)
        assert s1 == s4, strategy
    say("4cards.sw_dp", mesh="4x1", pairs=len(alts), strategies="0,2",
        identical=True)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-device mesh paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on any platform; prints no result")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from acc_genomics_tpu import native
    from acc_genomics_tpu.utils.cache import enable_persistent_cache
    from acc_genomics_tpu.utils.devtrace import compiled_programs, memory_line

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    if args.rehearse:
        CARD = "rehearsal, no card"
    else:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        print(cards, flush=True)
        CARD = cards.splitlines()[0]
    n_dev = len(jax.devices())
    say("setup", platform=dev.platform, device_kind=repr(dev.device_kind),
        devices=n_dev, jax=jax.__version__)
    t0 = time.perf_counter()
    native.build()
    native.get_lib()
    # omp_threads=0: make found no OpenMP, so the host engines and the
    # PairHMM fp64 recompute run on one core
    say("setup.native", build_s=round(time.perf_counter() - t0, 3),
        omp_threads=native.omp_threads())

    S = TOY if args.rehearse else FULL
    rng = np.random.default_rng(args.seed)
    with compiled_programs() as progs:
        if args.four_cards:
            phase_four_cards(rng, S)
        else:
            phase_pairhmm(rng, S)
            phase_sw(rng, S)
            phase_hc(rng, S)
            phase_bwamem(rng, S)
    for name, exe in sorted(progs.items()):
        print("[memory] " + memory_line(name, exe), flush=True)
    peaks = [d.memory_stats() or {} for d in jax.devices()[: 4 if args.four_cards else 1]]
    say("memory", programs=len(progs),
        peak_bytes_in_use=[p.get("peak_bytes_in_use") for p in peaks])
    if args.rehearse:
        print("rehearsal passed", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

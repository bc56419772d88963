"""Headline benchmark: all four kernels and both pipelines on one GPU.

Prints ONE JSON line.  The headline metric is PairHMM effective GCUPS
(kernel, real cells only) against the reference's published 15 GCUPS
FPGA average (pairhmm/xlnx/README.md, BASELINE.md row 1); ``extras``
carries the other cells:

  pairhmm_e2e_*      — streamed flat engine (benchmarks/pairhmm_e2e_bench)
  sw_e2e_gcups       — SW engine end to end (fill + device walk + decode)
  smem_*             — SMEM engine reads/s at 101 bp (toy, 16K, 100 Mbp)
  extend_*           — banded extension kernel and engine seeds/s
  bwamem_*           — fused BWA-MEM device pipeline reads/s
  hc_*               — HaplotypeCaller regions/s

Every time is a host clock around work that ends on the device (engine
calls return host arrays; kernel calls end in ``block_until_ready``),
min of K reps; ``*_device_busy_ms`` comes from a profiler trace.  The
100 Mbp index is built from its seed into ``data/`` when it is missing
(set-up time, reported).  The bench needs a GPU; any sub-bench error
is reported in the line and makes the exit code non-zero.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

INDEX_100M = "data/chr100m.fm.npz"


def _best(fn, k):
    """min over k calls of the host time of ``fn()``; per-rep ms."""
    dts = []
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        dts.append(time.perf_counter() - t0)
    return min(dts), [round(d * 1e3, 3) for d in dts]


def _busy_ms(fn):
    from acc_genomics_tpu.utils.devtrace import device_time

    return round(device_time(fn)["busy_ms"], 3)


def bench_pairhmm():
    """Effective GCUPS over real (unpadded) cells through the engine's
    device forward: read-length buckets, haplen-sorted packing, per-block
    trip counts.  The host time per rep covers all four buckets."""
    import jax
    import jax.numpy as jnp

    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.kernel import (
        kernel_for_platform,
        pairhmm_forward_pallas,
    )
    from acc_genomics_tpu.ops.pairhmm.jax_impl import pairhmm_forward
    from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch

    dev = jax.devices()[0]
    kernel = kernel_for_platform(dev.platform)
    rng = np.random.default_rng(0)
    rows_max, cols = 152, 384
    row_buckets = (64, 96, 128, rows_max)
    tcs = gen_pairhmm_pairs(rng, 8192, max_read_len=rows_max - 2,
                            max_hap_len=cols)
    groups = {b: [] for b in row_buckets}
    for t in tcs:
        groups[next(b for b in row_buckets if len(t["rs"]) < b)].append(t)
    packs = [
        pack_pairhmm_batch(g, rows=r, cols=cols, dtype=np.float32,
                           sort_by_haplen=True)
        for r, g in groups.items() if g
    ]
    args = [
        ([jax.device_put(v, dev) for v in p.arrays()],
         jax.device_put(p.rslen, dev), jax.device_put(p.haplen, dev))
        for p in packs
    ]
    cells = sum(p.cells for p in packs)

    def run():
        outs = [
            pairhmm_forward_pallas(*a, rl, hl) if kernel == "pallas"
            else pairhmm_forward(*a)
            for a, rl, hl in args
        ]
        jax.block_until_ready(outs)

    run()  # compile
    t, reps = _best(run, 5)
    return dict(gcups=cells / t / 1e9, kernel=kernel, rep_ms=reps,
                device_busy_ms=_busy_ms(run))


def bench_sw():
    """SW engine end-to-end GCUPS (device fill + walk + D2H + decode)."""
    from acc_genomics_tpu.engine.sw_engine import SWEngine
    from acc_genomics_tpu.io.synth import gen_sw_batch

    rng = np.random.default_rng(0)
    eng = SWEngine()
    ref, alts = gen_sw_batch(rng, 8192, ref_len=286)
    refs = [ref] * len(alts)
    eng.align(refs, alts, 0)  # compile
    t, reps = _best(lambda: eng.align(refs, alts, 0), 4)
    cells = sum(len(ref) * len(a) for a in alts)
    return dict(gcups=cells / t / 1e9, rep_ms=reps,
                device_busy_ms=_busy_ms(lambda: eng.align(refs, alts, 0)))


def _anatomy_extras(anatomy, prefix, reps):
    """Per-phase engine anatomy -> extras (ms per rep, MB per rep)."""
    out = {}
    for k, v in anatomy.items():
        if k.endswith("_s"):
            out[f"{prefix}_{k[:-2]}_ms"] = round(v / reps * 1e3, 3)
        else:
            out[f"{prefix}_{k[:-6]}_mb"] = round(v / reps / 1e6, 3)
    return out


def bench_smem(n_reads):
    """SMEM engine reads/s at 101 bp on a 100 kbp genome: the dict path
    (``collect``) and the array path (``collect_arrays``)."""
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads

    rng = np.random.default_rng(0)
    genome = gen_reference_with_repeats(rng, 100_000)
    eng = GenomicsEngine()
    eng.load_reference(genome)
    reads = gen_smem_reads(rng, genome, n_reads, read_len=101)
    eng.smem_collect(reads)  # compile
    K = 3
    iters0 = eng.smem.stats["probe_iters"]
    t, reps = _best(lambda: eng.smem_collect(reads), K)
    iters = (eng.smem.stats["probe_iters"] - iters0) / K
    out = dict(reads_per_s=n_reads / t, rep_ms=reps,
               probe_gb_s=iters * 2 * 32 * n_reads / t / 1e9)
    seq_tm = np.full((eng.smem.config.read_buckets[1], n_reads), 4, np.uint8)
    lens = np.zeros(n_reads, np.int32)
    for k, r in enumerate(reads):
        seq_tm[: len(r), k] = r
        lens[k] = len(r)
    arrays = lambda: eng.smem.collect_arrays(seq_tm, lens)
    arrays()  # compile
    eng.smem.reset_anatomy()
    t, _ = _best(arrays, K)
    out["arrays_reads_per_s"] = n_reads / t
    out["anatomy"] = dict(eng.smem.anatomy)
    out["anatomy_reps"] = K
    out["device_busy_ms"] = _busy_ms(arrays)
    return out


def load_index_100m():
    """The 100 Mbp index, built from its seed when ``data/`` lacks it;
    returns (fm, set-up seconds)."""
    from acc_genomics_tpu.io.synth import gen_reference_with_repeats
    from acc_genomics_tpu.ops.smem.index import FMIndex

    t0 = time.perf_counter()
    if os.path.exists(INDEX_100M):
        fm = FMIndex.load(INDEX_100M)
    else:
        genome = gen_reference_with_repeats(np.random.default_rng(0),
                                            100_000_000)
        fm = FMIndex.build(genome)
        os.makedirs(os.path.dirname(INDEX_100M), exist_ok=True)
        fm.save(INDEX_100M)
    return fm, time.perf_counter() - t0


def bench_smem_100m(fm):
    """SMEM engine at 100 Mbp, 101 bp reads: one 65536-lane batch
    (one-shot machine) and 8 x 65536 reads (multi-read machine, Q=8)."""
    from acc_genomics_tpu.engine.smem_engine import SmemEngine
    from acc_genomics_tpu.io.synth import gen_smem_reads

    rng = np.random.default_rng(0)
    genome = fm.text[: fm.seq_len // 2]
    eng = SmemEngine(fm)
    B = eng.config.batch_size
    Q = 8
    reads = gen_smem_reads(rng, genome, Q * B, read_len=101)
    seq_tm = np.full((128, Q * B), 4, np.uint8)
    lens = np.zeros(Q * B, np.int32)
    for k, r in enumerate(reads):
        seq_tm[: len(r), k] = r
        lens[k] = len(r)
    out = {}
    K = 3
    s1, l1 = seq_tm[:, :B], lens[:B]
    one = lambda: eng.collect_arrays(s1, l1)
    one()  # compile
    iters0 = eng.stats["probe_iters"]
    eng.reset_anatomy()
    t, out["rep_ms"] = _best(one, K)
    iters = (eng.stats["probe_iters"] - iters0) / K
    out["reads_per_s"] = B / t
    out["probe_gb_s"] = iters * 2 * 32 * B / t / 1e9
    out["anatomy_oneshot"] = dict(eng.anatomy)
    out["device_busy_ms_oneshot"] = _busy_ms(one)
    multi = lambda: eng.collect_arrays(seq_tm, lens)
    multi()  # compile
    eng.reset_anatomy()
    iters0 = eng.stats["probe_iters"]
    t, out["multi_rep_ms"] = _best(multi, K)
    out["multi_reads_per_s"] = Q * B / t
    out["multi_iters"] = int((eng.stats["probe_iters"] - iters0) / K)
    out["anatomy_multi"] = dict(eng.anatomy)
    out["anatomy_reps"] = K
    out["device_busy_ms_multi"] = _busy_ms(multi)
    return out


def bench_extend():
    """XLA banded extension kernel seeds/s at (2048 lanes, 128, 256)."""
    import jax
    import jax.numpy as jnp

    from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch

    rng = np.random.default_rng(0)
    B, Q, T = 2048, 128, 256
    q_tm = rng.integers(0, 4, (Q, B)).astype(np.int32)
    t_tm = rng.integers(0, 4, (T, B)).astype(np.int32)
    t_tm[:Q] = np.where(rng.random((Q, B)) < 0.95, q_tm, t_tm[:Q])
    qlen = np.full(B, 101, np.int32)
    tlen = np.full(B, 160, np.int32)
    h0 = np.full(B, 25, np.int32)
    args = [jnp.asarray(x) for x in (q_tm, t_tm, qlen, tlen, h0, qlen, qlen)]
    run = lambda: jax.block_until_ready(sw_extend_batch(*args))
    run()  # compile
    t, reps = _best(run, 5)
    return dict(seeds_per_s=B / t, rep_ms=reps, device_busy_ms=_busy_ms(run))


def bench_extend_engine():
    """Extend ENGINE e2e seeds/s (pack + upload + kernel + fetch + the
    gscore-vs-clip resolution)."""
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    engine = GenomicsEngine()
    n, read_len = 4096, 101
    seeds = []
    for _ in range(n):
        pos = int(rng.integers(200, len(genome) - 400))
        read = genome[pos : pos + read_len].copy()
        err = rng.random(read_len) < 0.04
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        qbeg = int(rng.integers(5, read_len - 30))
        slen = int(rng.integers(19, 25))
        read[qbeg : qbeg + slen] = genome[pos + qbeg : pos + qbeg + slen]
        span = genome[pos - 150 : pos + read_len + 150]
        seeds.append(dict(read=read, rseq=span, qbeg=qbeg,
                          rbeg_off=150 + qbeg, len=slen))
    run = lambda: engine.extend_seeds(seeds)
    run()  # compile
    K = 3
    engine.extend.reset_anatomy()
    t, reps = _best(run, K)
    return dict(seeds_per_s=n / t, rep_ms=reps,
                anatomy=dict(engine.extend.anatomy), anatomy_reps=K,
                device_busy_ms=_busy_ms(run))


def bench_hc():
    """HaplotypeCaller-core regions/s: batched process_regions (SW
    realignment + PairHMM likelihoods) over 64 regions of 24 reads."""
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.models.haplotype_caller import HaplotypeCallerCore
    from drivers.hc_driver import gen_region

    rng = np.random.default_rng(0)
    n_regions = 64
    hc = HaplotypeCallerCore(GenomicsEngine())
    regions = [gen_region(rng, n_reads=24)[:3] for _ in range(n_regions)]
    run = lambda: hc.process_regions(regions)
    run()  # compile
    K = 3
    hc.reset_anatomy()
    t, reps = _best(run, K)
    return dict(regions_per_s=n_regions / t, rep_ms=reps,
                anatomy=dict(hc.anatomy), anatomy_reps=K,
                device_busy_ms=_busy_ms(run))


def bench_bwamem(fm=None):
    """Fused BWA-MEM device pipeline reads/s (2048 reads of 101 bp) on a
    2 Mbp random genome, or on ``fm`` (the 100 Mbp index)."""
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.io.synth import gen_smem_reads
    from acc_genomics_tpu.models.bwa_mem import BwaMemDevicePipeline

    rng = np.random.default_rng(0)
    eng = GenomicsEngine()
    if fm is None:
        genome = rng.integers(0, 4, 2_000_000).astype(np.uint8)
        eng.load_reference(genome)
    else:
        genome = fm.text[: fm.seq_len // 2]
        eng.set_index(fm)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=100)
    n = 2048
    reads = gen_smem_reads(rng, genome, n, read_len=101)
    run = lambda: pipe.map_reads_arrays(reads)
    run()  # compile
    K = 3
    pipe.reset_anatomy()
    t, reps = _best(run, K)
    return dict(reads_per_s=n / t, rep_ms=reps, seeds=pipe.stats["seeds"],
                anatomy=dict(pipe.anatomy), anatomy_reps=K,
                device_busy_ms=_busy_ms(run))


def main():
    import jax

    from acc_genomics_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from acc_genomics_tpu import native

    # 0 means make found no OpenMP: the host engines run on one core
    extras, errors = {"native_omp_threads": native.omp_threads()}, {}

    def run(name, fn, record):
        try:
            record(fn())
        except Exception as e:  # reported, and the exit code says so
            errors[name] = f"{type(e).__name__}: {e}"[:300]

    headline = {}
    run("pairhmm", bench_pairhmm, headline.update)

    def rec_e2e(r):
        extras["pairhmm_e2e_gcups"] = round(r["e2e_gcups"], 3)
        extras["pairhmm_pack_gcups_core"] = round(r["pack_gcups_per_core"], 3)
        extras["pairhmm_stream_mb"] = round(r["stream_bytes"] / 1e6, 3)
        extras["pairhmm_stream_launch_s"] = round(r["stream_launch_s"], 3)
        extras["pairhmm_stream_finalize_s"] = round(r["stream_finalize_s"], 3)

    from benchmarks.pairhmm_e2e_bench import run as e2e_run

    run("pairhmm_e2e", lambda: e2e_run(n_batches=6, quiet=True), rec_e2e)

    def rec_sw(r):
        extras["sw_e2e_gcups"] = round(r["gcups"], 3)
        extras["sw_rep_ms"] = r["rep_ms"]
        extras["sw_device_busy_ms"] = r["device_busy_ms"]

    run("sw", bench_sw, rec_sw)

    def rec_smem(suffix):
        def rec(r):
            extras[f"smem_reads_per_s{suffix}"] = round(r["reads_per_s"], 1)
            extras[f"smem_rep_ms{suffix}"] = r["rep_ms"]
            extras[f"smem_probe_gb_s{suffix}"] = round(r["probe_gb_s"], 3)
            extras[f"smem_arrays_reads_per_s{suffix}"] = round(
                r["arrays_reads_per_s"], 1)
            extras[f"smem_device_busy_ms{suffix}"] = r["device_busy_ms"]
            extras.update(_anatomy_extras(
                r["anatomy"], f"smem{suffix or '_toy'}", r["anatomy_reps"]))
        return rec

    run("smem", lambda: bench_smem(65536), rec_smem(""))
    run("smem_16k", lambda: bench_smem(16384), rec_smem("_16k"))

    fm100 = {}

    def rec_index(r):
        fm100["fm"], s = r
        extras["index_100m_setup_s"] = round(s, 3)

    run("index_100m", load_index_100m, rec_index)

    def rec_smem_100m(r):
        extras["smem_reads_per_s_100m"] = round(r["reads_per_s"], 1)
        extras["smem_rep_ms_100m"] = r["rep_ms"]
        extras["smem_probe_gb_s_100m"] = round(r["probe_gb_s"], 3)
        extras["smem_multi_reads_per_s_100m"] = round(r["multi_reads_per_s"], 1)
        extras["smem_multi_rep_ms_100m"] = r["multi_rep_ms"]
        extras["smem_multi_iters_100m"] = r["multi_iters"]
        extras["smem_device_busy_ms_100m_oneshot"] = r["device_busy_ms_oneshot"]
        extras["smem_device_busy_ms_100m_multi"] = r["device_busy_ms_multi"]
        extras.update(_anatomy_extras(r["anatomy_oneshot"], "smem_100m",
                                      r["anatomy_reps"]))
        extras.update(_anatomy_extras(r["anatomy_multi"], "smem_100m_multi",
                                      r["anatomy_reps"]))

    if "fm" in fm100:
        run("smem_100m", lambda: bench_smem_100m(fm100["fm"]), rec_smem_100m)

    def rec_extend(r):
        extras["extend_kernel_seeds_per_s"] = round(r["seeds_per_s"], 1)
        extras["extend_kernel_rep_ms"] = r["rep_ms"]
        extras["extend_kernel_device_busy_ms"] = r["device_busy_ms"]

    run("extend", bench_extend, rec_extend)

    def rec_extend_engine(r):
        extras["extend_engine_seeds_per_s"] = round(r["seeds_per_s"], 1)
        extras["extend_engine_rep_ms"] = r["rep_ms"]
        extras["extend_engine_device_busy_ms"] = r["device_busy_ms"]
        extras.update(_anatomy_extras(r["anatomy"], "extend_eng",
                                      r["anatomy_reps"]))

    run("extend_engine", bench_extend_engine, rec_extend_engine)

    def rec_bwamem(suffix):
        def rec(r):
            extras[f"bwamem_reads_per_s_{suffix}"] = round(r["reads_per_s"], 1)
            extras[f"bwamem_rep_ms_{suffix}"] = r["rep_ms"]
            extras[f"bwamem_device_busy_ms_{suffix}"] = r["device_busy_ms"]
            extras.update(_anatomy_extras(r["anatomy"], f"bwamem_{suffix}",
                                          r["anatomy_reps"]))
        return rec

    run("bwamem_2m", bench_bwamem, rec_bwamem("2m"))
    if "fm" in fm100:
        run("bwamem_100m", lambda: bench_bwamem(fm100["fm"]),
            rec_bwamem("100m"))

    def rec_hc(r):
        extras["hc_regions_per_s"] = round(r["regions_per_s"], 1)
        extras["hc_rep_ms"] = r["rep_ms"]
        extras["hc_device_busy_ms"] = r["device_busy_ms"]
        extras.update(_anatomy_extras(r["anatomy"], "hc", r["anatomy_reps"]))

    run("hc", bench_hc, rec_hc)

    gcups = headline.get("gcups")
    extras["pairhmm_kernel"] = headline.get("kernel")
    extras["pairhmm_rep_ms"] = headline.get("rep_ms")
    extras["pairhmm_device_busy_ms"] = headline.get("device_busy_ms")
    if errors:
        extras["errors"] = errors
    print(json.dumps({
        "metric": "pairhmm_effective_gcups_1chip",
        "value": round(gcups, 3) if gcups is not None else None,
        "unit": "GCUPS",
        "vs_baseline": round(gcups / 15.0, 3) if gcups is not None else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "extras": extras,
    }))
    sys.exit(1 if errors else 0)


if __name__ == "__main__":
    main()

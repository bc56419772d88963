#!/usr/bin/env python
"""PairHMM end-to-end bench: streamed flat engine, with its anatomy.

Runs the depth-2 streamed engine loop (``compute_pairs_flat_stream``)
over GATK-shaped batches and reports wall-clock e2e GCUPS beside the
pieces that bound it: host pack rate per core, one H2D of a packed
buffer, the stream's launch / finalize split, and the device busy time
of the same stream from a profiler trace (its share of the wall is the
device occupancy).  The reference's 15 GCUPS is a production e2e
average (pairhmm/xlnx/README.md:33-35).

  python benchmarks/pairhmm_e2e_bench.py [--batches 8] [--pairs 8192]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_flat_batches(rng, n_batches, n_pairs, max_read_len=150,
                      max_hap_len=384):
    """GATK-shaped pairs: reads sampled FROM haplotype windows with ~1%
    errors (derived=True), so the fp64 recompute stays the exception as
    on real WES data.  Independent random pairs underflow ~75% of the
    time and would measure the host fp64 engine instead."""
    from acc_genomics_tpu.io.synth import gen_pairhmm_input

    batches = []
    for _ in range(n_batches):
        # fixed-length reads (real WES corpora are uniform-length)
        reads, haps = gen_pairhmm_input(
            rng, n_pairs, n_pairs, max_read_len=max_read_len,
            max_hap_len=max_hap_len, min_read_len=max_read_len,
            derived=True,
        )
        cat = lambda xs: np.concatenate(xs).astype(np.uint8)
        batches.append((
            cat([r["rs"] for r in reads]), cat([r["q"] for r in reads]),
            cat([r["i"] for r in reads]), cat([r["d"] for r in reads]),
            cat([r["c"] for r in reads]),
            np.array([len(r["rs"]) for r in reads], np.int32),
            cat(haps), np.array([len(h) for h in haps], np.int32),
        ))
    return batches


def run(n_batches=8, n_pairs=8192, quiet=False):
    import jax

    from acc_genomics_tpu import native
    from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu.utils.convert import HAP_PAD
    from acc_genomics_tpu.utils.devtrace import device_time

    rng = np.random.default_rng(0)
    batches = make_flat_batches(rng, n_batches, n_pairs)
    cells_per_batch = [int((b[5].astype(np.int64) * b[7]).sum())
                       for b in batches]
    cells = sum(cells_per_batch)
    eng = PairHMMEngine()

    # warm every jit shape, then one batch's latency
    eng.compute_pairs_flat(*batches[0])
    t0 = time.perf_counter()
    eng.compute_pairs_flat(*batches[0])
    lat = time.perf_counter() - t0

    # streamed steady state (the headline e2e)
    st0 = dict(eng.stats)
    t0 = time.perf_counter()
    outs = eng.compute_pairs_flat_stream(batches)
    wall = time.perf_counter() - t0
    e2e = cells / wall / 1e9
    delta = lambda k: eng.stats.get(k, 0) - st0.get(k, 0)
    stream_bytes = delta("h2d_bytes") + delta("d2h_bytes")
    busy_ms = device_time(lambda: eng.compute_pairs_flat_stream(batches))[
        "busy_ms"]

    # host pack rate of one batch at the widest bucket, one core
    rs, q, i, d, c, lens, hap, hlens = batches[0]
    offs = np.concatenate([[0], np.cumsum(lens[:-1], dtype=np.int64)])
    hoffs = np.concatenate([[0], np.cumsum(hlens[:-1], dtype=np.int64)])
    rows, cols = 152, 384
    pack = lambda: native.pairhmm_pack_quals_flat(
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens, rows, cols, HAP_PAD)
    pack()
    t0 = time.perf_counter()
    for _ in range(5):
        pack()
    pack_dt = (time.perf_counter() - t0) / 5

    # one H2D of a packed-size buffer
    big = np.zeros((5 * rows + rows + cols, n_pairs), np.uint8)
    jax.device_put(big, eng.device).block_until_ready()
    t0 = time.perf_counter()
    for k in range(3):
        big[0, 0] = k
        jax.device_put(big, eng.device).block_until_ready()
    link_dt = (time.perf_counter() - t0) / 3

    res = dict(
        e2e_gcups=e2e,
        pack_gcups_per_core=cells_per_batch[0] / pack_dt / 1e9,
        link_gb_s=big.size / link_dt / 1e9,
        stream_bytes=stream_bytes,
        stream_launch_s=delta("stream_launch_s"),
        stream_finalize_s=delta("stream_finalize_s"),
        device_busy_ms=busy_ms,
        device_occupancy=min(1.0, busy_ms * 1e-3 / wall),
        single_batch_latency_s=lat,
        wall_s=wall, cells=cells, n_batches=n_batches,
    )
    assert all(np.isfinite(o).all() for o in outs)
    if not quiet:
        for k, v in res.items():
            print(f"{k:24s} {v}")
    return res


if __name__ == "__main__":
    from acc_genomics_tpu.utils.cache import enable_persistent_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=8192)
    args = ap.parse_args()
    enable_persistent_cache()
    run(args.batches, args.pairs)

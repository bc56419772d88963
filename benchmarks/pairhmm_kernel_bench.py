"""PairHMM forward: the Pallas wavefront kernel against the XLA row scan.

Kernel mode (default): for each row bucket 64 / 96 / 128 / 152 it packs
8192 pairs (reads shorter than the bucket, haplotypes <= 384, sorted by
haplotype length) and prints one JSON line per variant: host time per
call (min of reps, each ending in ``block_until_ready``), device busy
time from a profiler trace, effective GCUPS on both, and the largest
relative difference from the XLA result over pairs above the fp32 floor.

End-to-end mode (``--e2e``): the engine paths that run the forward, for
each kernel of ``--e2e-variants``, run forward and then backward:
``PairHMMEngine.compute_pairs_flat`` on 8192 random pairs (reads <= 151,
haps <= 384, chip_smoke's phase 1) and on 8192 GATK-shaped pairs (reads
sampled from their haplotypes), and ``HaplotypeCallerCore.process_regions``
on 64 regions of 24 reads.  The engine takes its kernel from the
platform rule, so the bench swaps the rule while it builds each engine.
Needs a GPU.

    python benchmarks/pairhmm_kernel_bench.py [--variants xla,pallas] [--e2e]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

ROW_BUCKETS = (64, 96, 128, 152)
COLS = 384


def bucket_pack(rows, n_pairs, seed=0):
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch

    rng = np.random.default_rng(seed + rows)
    tcs = gen_pairhmm_pairs(rng, n_pairs, max_read_len=rows - 1,
                            max_hap_len=COLS)
    return pack_pairhmm_batch(tcs, rows=rows, cols=COLS, dtype=np.float32,
                              sort_by_haplen=True)


def variant_fn(name, pack):
    """'xla' or 'pallas[:block[:band]]' -> a no-argument device call."""
    import jax.numpy as jnp

    from acc_genomics_tpu.ops.pairhmm.jax_impl import pairhmm_forward
    from acc_genomics_tpu.ops.pairhmm.kernel import pairhmm_forward_pallas

    a = [jnp.asarray(v) for v in pack.arrays()]
    if name == "xla":
        return lambda: pairhmm_forward(*a)
    parts = name.split(":")
    block = int(parts[1]) if len(parts) > 1 else 32
    band = int(parts[2]) if len(parts) > 2 else 8
    rl, hl = jnp.asarray(pack.rslen), jnp.asarray(pack.haplen)
    return lambda: pairhmm_forward_pallas(
        *a, rl, hl, block=block, band=band
    )


def run_kernels(args, kind):
    import jax

    from acc_genomics_tpu.utils.devtrace import device_time

    for rows in ROW_BUCKETS:
        pack = bucket_pack(rows, args.pairs)
        ref = None
        for name in args.variants.split(","):
            fn = variant_fn(name, pack)
            t0 = time.perf_counter()
            out = np.asarray(jax.block_until_ready(fn()))
            compile_s = time.perf_counter() - t0
            if name == "xla":
                ref = out
            dts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                dts.append(time.perf_counter() - t0)
            tr = device_time(lambda: jax.block_until_ready(fn()))
            diff = None
            if ref is not None:
                ok = ref >= 1e-28  # the fp32 contract's floor
                diff = float(np.max(np.abs(out[ok] - ref[ok]) / ref[ok],
                                    initial=0.0))
            print(json.dumps(dict(
                bench="pairhmm_kernel", variant=name, rows=rows, cols=COLS,
                pairs=pack.n_real, cells=pack.cells,
                host_ms=min(dts) * 1e3, device_busy_ms=tr["busy_ms"],
                gcups_host=pack.cells / min(dts) / 1e9,
                gcups_device=pack.cells / (tr["busy_ms"] * 1e-3) / 1e9,
                first_call_s=compile_s, rel_diff_vs_xla=diff, card=kind,
            )), flush=True)
            if args.show_trace:
                args.show_trace = False
                print(json.dumps(dict(lines=tr["lines"],
                                      kernels=tr["kernels"])), flush=True)


def run_e2e(args, kind):
    from unittest import mock

    from drivers.hc_driver import gen_region

    from acc_genomics_tpu.engine import pairhmm_engine
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.models.haplotype_caller import HaplotypeCallerCore
    from acc_genomics_tpu.utils.devtrace import device_time
    from benchmarks.pairhmm_e2e_bench import make_flat_batches

    rng = np.random.default_rng(0)
    tcs = gen_pairhmm_pairs(rng, args.pairs, max_read_len=151,
                            max_hap_len=COLS)
    cat = lambda k: np.concatenate([np.asarray(t[k], np.uint8) for t in tcs])
    flats = dict(
        random=(cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
                np.array([len(t["rs"]) for t in tcs], np.int32), cat("hap"),
                np.array([len(t["hap"]) for t in tcs], np.int32)),
        gatk=make_flat_batches(rng, 1, args.pairs)[0],
    )
    regions = [gen_region(rng, n_reads=24)[:3] for _ in range(64)]

    def timed(fn):
        fn()  # compile
        dts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            dts.append(time.perf_counter() - t0)
        return min(dts), device_time(fn)["busy_ms"]

    variants = args.e2e_variants.split(",")
    outs = {}
    for kernel in variants + variants[::-1]:
        with mock.patch.object(pairhmm_engine, "kernel_for_platform",
                               lambda _platform: kernel):
            ge = GenomicsEngine()
        eng = ge.pairhmm
        assert eng.kernel == kernel
        row = dict(bench="pairhmm_e2e", kernel=kernel, card=kind)
        for name, flat in flats.items():
            cells = int((flat[5].astype(np.int64) * flat[7]).sum())
            s, busy = timed(lambda: eng.compute_pairs_flat(*flat))
            outs.setdefault((name, kernel), eng.compute_pairs_flat(*flat))
            row.update({f"{name}_ms": s * 1e3,
                        f"{name}_device_busy_ms": busy,
                        f"{name}_gcups": cells / s / 1e9})
        hc = HaplotypeCallerCore(ge)
        s, busy = timed(lambda: hc.process_regions(regions))
        row.update(hc_ms=s * 1e3, hc_device_busy_ms=busy,
                   hc_regions_per_s=len(regions) / s)
        print(json.dumps(row), flush=True)
    base = outs[("gatk", variants[0])]
    print(json.dumps(dict(bench="pairhmm_e2e", rel_diff_vs_first={
        k[1]: float(np.max(np.abs(v - base) / np.abs(base)))
        for k, v in outs.items() if k[0] == "gatk"
    })), flush=True)


def main(argv=None):
    import subprocess

    import jax

    from acc_genomics_tpu.utils.cache import enable_persistent_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="xla,pallas")
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--e2e-variants", default="pallas,xla",
                    help="engine kernels for --e2e")
    ap.add_argument("--show-trace", action="store_true",
                    help="print the trace's device lines and top kernels")
    args = ap.parse_args(argv)
    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    kind = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.e2e:
        run_e2e(args, kind)
    else:
        run_kernels(args, kind)


if __name__ == "__main__":
    main()

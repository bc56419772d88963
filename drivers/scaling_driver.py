#!/usr/bin/env python
"""Scaling scoreboard: data-parallel PairHMM over 1..N devices.

The analog of the reference's multi-die / multi-worker scaling story
(SLR-proportional distribution, Blaze worker tiling): shard the packed
batch over a growing "data" mesh and report throughput + parallel
efficiency per device count.  Each shard runs the device's PairHMM
forward (``kernel_for_platform``).  Runs on whatever jax.devices()
offers; ``XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu`` gives a virtual 8-device CPU mesh.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from acc_genomics_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.kernel import kernel_for_platform
    from acc_genomics_tpu.ops.pairhmm.pack import LANES, pack_pairhmm_batch
    from acc_genomics_tpu.parallel import make_mesh
    from acc_genomics_tpu.parallel.sharded import pairhmm_forward_dp, shard_lanes

    n_dev = len(jax.devices())
    kernel = kernel_for_platform(jax.devices()[0].platform)
    rng = np.random.default_rng(0)
    tcs = gen_pairhmm_pairs(
        rng, args.pairs, max_read_len=args.rows - 2, max_hap_len=args.cols
    )
    counts = [d for d in (1, 2, 4, 8, 16) if d <= n_dev]
    pack = pack_pairhmm_batch(tcs, rows=args.rows, cols=args.cols,
                              sort_by_haplen=True,
                              lane_multiple=LANES * counts[-1])
    host = list(pack.arrays()) + [pack.rslen, pack.haplen]
    cells = pack.cells
    if jax.devices()[0].platform == "cpu" and n_dev > 1:
        print(
            "NOTE: virtual host devices share one physical CPU — this run "
            "validates the sharded path; speedups only appear on real cards"
        )
    base_rate = None
    for d in counts:
        mesh = make_mesh((d, 1))
        a = shard_lanes(mesh, host)

        def fwd():
            return jax.block_until_ready(pairhmm_forward_dp(
                mesh, *a[:11], rslen=a[11], haplen=a[12], kernel=kernel,
            ))

        fwd()  # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fwd()
        dt = (time.perf_counter() - t0) / args.reps
        rate = cells / dt / 1e9
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d)
        print(
            f"{d} device(s), {kernel}: {rate:8.3f} GCUPS  "
            f"speedup {rate/base_rate:5.2f}x  efficiency {eff:5.1%}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

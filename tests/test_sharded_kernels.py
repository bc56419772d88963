"""Data-parallel SMEM / extend / SW over the virtual 8-device mesh."""

import numpy as np
import jax.numpy as jnp

from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch
from acc_genomics_tpu.ops.smem.index import FMIndex
from acc_genomics_tpu.ops.smem.machine import device_index_fused, smem_collect_machine
from acc_genomics_tpu.parallel import make_mesh
from acc_genomics_tpu.parallel.sharded_kernels import (
    smem_collect_dp,
    sw_extend_dp,
    sw_device_dp,
)


def test_smem_dp_matches_single(rng):
    genome = gen_reference_with_repeats(rng, 1200)
    fm = FMIndex.build(genome)
    idx = device_index_fused(fm)
    reads = gen_smem_reads(rng, genome, 16, read_len=60)
    seq_tm = np.full((64, 16), 4, np.int32)
    lens = np.zeros(16, np.int32)
    for k, r in enumerate(reads):
        seq_tm[: len(r), k] = r
        lens[k] = len(r)
    seq_tm = jnp.asarray(seq_tm)
    lens = jnp.asarray(lens)

    mem1, n1, _ = smem_collect_machine(idx, seq_tm, lens)
    mesh = make_mesh((8, 1))
    mem8, n8, iters = smem_collect_dp(mesh, idx, seq_tm, lens)
    assert np.array_equal(np.asarray(n1), np.asarray(n8))
    for a, b in zip(mem1, mem8):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(iters).shape == (8,)


def test_smem_multi_dp_matches_single(rng):
    """Mesh form of the MULTI-READ machine: same packed pool through
    smem_collect_multi_dp (lanes sharded over "data") and the
    single-device jit must agree bit-for-bit."""
    from acc_genomics_tpu.config import SmemConfig
    from acc_genomics_tpu.engine.smem_engine import SmemEngine
    from acc_genomics_tpu.ops.smem.machine import _collect_multi_jit
    from acc_genomics_tpu.parallel.sharded_kernels import (
        smem_collect_multi_dp,
    )

    genome = gen_reference_with_repeats(rng, 1200)
    fm = FMIndex.build(genome)
    eng = SmemEngine(fm, SmemConfig(batch_size=8, seq_length=32,
                                    read_buckets=(32,)))
    reads = gen_smem_reads(rng, genome, 24, read_len=30)
    seq_tm = np.full((32, 24), 4, np.uint8)
    lens = np.zeros(24, np.int32)
    for k, r in enumerate(reads):
        seq_tm[: len(r), k] = r
        lens[k] = len(r)
    packed, lens_q, Q, mp = eng._multi_pack(seq_tm, lens, 8)
    assert Q == 3
    packed, lens_q = jnp.asarray(packed), jnp.asarray(lens_q)
    idx = device_index_fused(fm)  # un-placed: shard_map replicates it
    mem1, n1, bnd1, bq1, _ = _collect_multi_jit(
        idx, packed, lens_q, params=mp, reads_per_lane=Q
    )
    mesh = make_mesh((8, 1))
    mem8, n8, bnd8, bq8, iters = smem_collect_multi_dp(
        mesh, idx, packed, lens_q, reads_per_lane=Q, params=mp
    )
    assert np.array_equal(np.asarray(n1), np.asarray(n8))
    assert np.array_equal(np.asarray(bnd1), np.asarray(bnd8))
    assert np.array_equal(np.asarray(bq1), np.asarray(bq8))
    for a, b in zip(mem1, mem8):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(iters).shape == (8,)


def test_smem_engine_multi_mesh_route(rng):
    """SmemEngine.collect with a mesh routes wide batches through the
    multi-read mesh machine (no silent one-shot downgrade) and stays
    oracle-exact end to end."""
    from acc_genomics_tpu.config import SmemConfig
    from acc_genomics_tpu.engine.smem_engine import SmemEngine
    from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle

    genome = gen_reference_with_repeats(rng, 1500)
    fm = FMIndex.build(genome)
    mesh = make_mesh((8, 1))
    eng = SmemEngine(
        fm,
        SmemConfig(batch_size=8, max_reads_per_lane=4, seq_length=32,
                   read_buckets=(32,)),
        mesh=mesh,
    )
    reads = gen_smem_reads(rng, genome, 20, read_len=28)
    got = eng.collect(reads)

    def _canon2(z):
        return sorted(
            (i["x0"], i["x1"], i["s"], i["start"], i["end"]) for i in z
        )

    for r, g in zip(reads, got):
        assert _canon2(g) == _canon2(
            mem_collect_intv_oracle(fm, r, eng.params)
        )


def test_extend_dp_matches_single(rng):
    B, Q, T = 16, 32, 48
    q = rng.integers(0, 4, (Q, B)).astype(np.int32)
    t = rng.integers(0, 4, (T, B)).astype(np.int32)
    qlen = np.full(B, Q, np.int32)
    tlen = np.full(B, T, np.int32)
    h0 = np.full(B, 20, np.int32)
    args = [jnp.asarray(v) for v in (q, t, qlen, tlen, h0, qlen, qlen)]
    r1 = sw_extend_batch(*args)
    mesh = make_mesh((8, 1))
    r8 = sw_extend_dp(mesh, *args)
    for k in r1:
        assert np.array_equal(np.asarray(r1[k]), np.asarray(r8[k]))


def test_sw_fill_dp_matches_single(rng):
    """The SW device path (XLA fill + device walker) sharded over "data"
    returns the single-device element buffers exactly."""
    from acc_genomics_tpu.ops.sw.walker import sw_align_device

    B, R, C = 16, 24, 32
    ref = rng.integers(0, 4, (R, B)).astype(np.uint8)
    alt = ref[:C].copy() if C <= R else np.resize(ref, (C, B))
    mut = rng.random(alt.shape) < 0.15
    alt[mut] = (alt[mut] + 1) % 4
    rl = rng.integers(R // 2, R + 1, B).astype(np.int32)
    al = rng.integers(C // 2, C + 1, B).astype(np.int32)
    a = [jnp.asarray(v) for v in (ref, alt, rl, al)]
    mesh = make_mesh((8, 1))
    for strategy in range(4):
        one = np.asarray(sw_align_device(*a, strategy))
        dp = np.asarray(sw_device_dp(mesh, *a, strategy))
        assert np.array_equal(one, dp), strategy

"""Multi-device sharding on the virtual 8-CPU mesh."""

import jax
import numpy as np
import pytest

from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu.ops.pairhmm.jax_impl import forward_from_pack
from acc_genomics_tpu.parallel import make_mesh, pairhmm_forward_dp, pairhmm_forward_dpsp

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _pack(rng, n, rows=16, cols=32):
    tcs = gen_pairhmm_pairs(rng, n, max_read_len=rows - 1, max_hap_len=cols)
    return pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32)


@needs_8
def test_dp_matches_single(rng):
    pack = _pack(rng, 256)
    mesh = make_mesh((8, 1))
    import jax.numpy as jnp
    args = [jnp.asarray(v) for v in pack.arrays()]
    got = np.asarray(pairhmm_forward_dp(mesh, *args))
    want = np.asarray(forward_from_pack(pack))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@needs_8
def test_dpsp_matches_single(rng):
    pack = _pack(rng, 128, rows=16, cols=32)
    mesh = make_mesh((2, 4))
    import jax.numpy as jnp
    args = [jnp.asarray(v) for v in pack.arrays()]
    got = np.asarray(pairhmm_forward_dpsp(mesh, *args))
    want = np.asarray(forward_from_pack(pack))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@needs_8
def test_dp_pallas_matches_single(rng):
    """The wavefront kernel as the per-shard body of the DP forward
    (interpret mode on the CPU mesh) matches the single-device XLA
    forward."""
    pack = _pack(rng, 256, rows=16, cols=32)
    mesh = make_mesh((8, 1))
    import jax.numpy as jnp
    args = [jnp.asarray(v) for v in pack.arrays()]
    got = np.asarray(pairhmm_forward_dp(
        mesh, *args, rslen=jnp.asarray(pack.rslen),
        haplen=jnp.asarray(pack.haplen), kernel="pallas", interpret=True,
    ))
    want = np.asarray(forward_from_pack(pack))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@needs_8
def test_shard_lanes_places_each_shard_on_its_device(rng):
    """Engine inputs go straight to their shards: no array is staged
    whole on one device first."""
    from acc_genomics_tpu.parallel.sharded import shard_lanes

    pack = _pack(rng, 256)
    mesh = make_mesh((4, 2))
    a2, a1 = shard_lanes(mesh, [pack.p_mm, pack.y0])
    for a in (a2, a1):
        shards = a.addressable_shards
        assert len({s.device for s in shards}) == 8
        assert all(s.data.shape[-1] == pack.batch // 4 for s in shards)
    np.testing.assert_array_equal(np.asarray(a2), pack.p_mm)


@needs_8
def test_dpsp_seq_only(rng):
    pack = _pack(rng, 128, rows=16, cols=64)
    mesh = make_mesh((1, 8))
    import jax.numpy as jnp
    args = [jnp.asarray(v) for v in pack.arrays()]
    got = np.asarray(pairhmm_forward_dpsp(mesh, *args))
    want = np.asarray(forward_from_pack(pack))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_genomics_engine_on_mesh(rng):
    """GenomicsEngine(mesh=...) shards batches over the data axis and
    matches the single-device engine exactly / within contract."""
    from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu.io.synth import (
        gen_pairhmm_input,
        gen_reference_with_repeats,
        gen_smem_reads,
    )
    from acc_genomics_tpu.parallel import make_mesh

    mesh = make_mesh((8, 1))
    em = GenomicsEngine(mesh=mesh)
    e1 = GenomicsEngine()
    em.pairhmm.min_device_cells = 0
    e1.pairhmm.min_device_cells = 0

    reads, haps = gen_pairhmm_input(rng, 5, 2, max_read_len=25, max_hap_len=40)
    np.testing.assert_allclose(
        em.pairhmm_matrix(reads, haps), e1.pairhmm_matrix(reads, haps), rtol=1e-12
    )

    genome = gen_reference_with_repeats(rng, 1200)
    em.load_reference(genome)
    e1.load_reference(genome)
    sreads = gen_smem_reads(rng, genome, 5, read_len=60)
    assert em.smem_collect(sreads) == e1.smem_collect(sreads)

    pos = 400
    read = genome[pos : pos + 60].copy()
    seeds = [
        dict(read=read, rseq=genome[pos - 30 : pos + 90], qbeg=20,
             rbeg_off=50, len=20)
    ]
    assert em.extend_seeds(seeds) == e1.extend_seeds(seeds)

"""Data-parallel distributed forms of the SMEM / extend / SW kernels.

Reads, seeds, and alignment pairs are independent, so the distributed
axis is pure data parallelism: shard the lane/batch dimension over the
"data" mesh axis with shard_map, replicate the FM-index (the analog of
the reference replicating the BWT into every DRAM bank and the pac into
both device DDR banks — smem/host/ocl.cpp:176-292, BWAOCLEnv.h), and
merge with zero collectives (outputs come back sharded the same way).

PairHMM's richer DP x SP form lives in parallel/sharded.py.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch
from acc_genomics_tpu.ops.extend.reference import (
    DEFAULT_EXTEND_PARAMS,
    ExtendParams,
)
from acc_genomics_tpu.ops.smem.machine import smem_collect_machine
from acc_genomics_tpu.ops.smem.reference import DEFAULT_SMEM_PARAMS, SmemParams
from acc_genomics_tpu.ops.sw.reference import DEFAULT_SW_PARAMS, SWParams


# Each form memoizes one jitted shard_map per (mesh, statics): building a
# fresh shard_map per call retraces and recompiles every invocation.


@functools.lru_cache(maxsize=None)
def _smem_dp_fn(mesh: Mesh, idx_keys, params: SmemParams):
    import jax.numpy as jnp

    idx_spec = {k: P() for k in idx_keys}

    def wrapped(idx_, s_, l_):
        mem, mem_n, iters = smem_collect_machine(idx_, s_, l_, params=params)
        # iters differs per shard: ship it as a per-shard (1,) vector
        return mem, mem_n, jnp.broadcast_to(iters, (1,))

    return jax.jit(jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(idx_spec, P(None, "data"), P("data")),
        out_specs=((P(None, "data"),) * 5, P("data"), P("data")),
    ))


def smem_collect_dp(mesh: Mesh, idx, seq_tm, lens,
                    params: SmemParams = DEFAULT_SMEM_PARAMS):
    """SMEM state machine, reads sharded over "data", index replicated.

    seq_tm (L, B), lens (B,); B must divide by the data-axis size.
    Returns (mem arrays (max_intv_alloc, B) x5, mem_n (B,), iters per shard).
    """
    return _smem_dp_fn(mesh, tuple(sorted(idx)), params)(idx, seq_tm, lens)


@functools.lru_cache(maxsize=None)
def _smem_multi_dp_fn(mesh: Mesh, idx_keys, params: SmemParams, Q: int):
    import jax.numpy as jnp

    idx_spec = {k: P() for k in idx_keys}

    def wrapped(idx_, packed_, lens_):
        mem, mem_n, bnd, bq, iters = smem_collect_machine(
            idx_, packed_, lens_, params=params, reads_per_lane=Q
        )
        return mem, mem_n, bnd, bq, jnp.broadcast_to(iters, (1,))

    return jax.jit(jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(idx_spec, P(None, "data"), P(None, "data")),
        out_specs=(
            (P(None, "data"),) * 5,
            P("data"),
            P(None, "data"),
            P(None, "data"),
            P("data"),
        ),
    ))


def smem_collect_multi_dp(mesh: Mesh, idx, packed, lens_q, reads_per_lane,
                          params: SmemParams = DEFAULT_SMEM_PARAMS):
    """MULTI-READ SMEM machine (Q reads per lane, in-body switching),
    lanes sharded over "data", index replicated — the mesh form of the
    engine's genome-scale production path, so distributed collection gets
    the same CLT step-count win as one chip (the bank-level data
    parallelism of smem/host/ocl.cpp:296-363: every DRAM bank holds the
    whole BWT and serves an independent slice of the read stream).

    packed: (3*Q*L/32, B_lane) int32 pre-packed 2-bit pool planes
    (SmemEngine._multi_pack layout); lens_q: (Q, B_lane).  B_lane must
    divide by the data-axis size.  Returns (mem x5 (rows, B), mem_n (B,),
    bnd (Q, B), bustq (Q, B), iters per shard)."""
    return _smem_multi_dp_fn(
        mesh, tuple(sorted(idx)), params, int(reads_per_lane)
    )(idx, packed, lens_q)


@functools.lru_cache(maxsize=None)
def _extend_dp_fn(mesh: Mesh, params: ExtendParams):
    def body(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del):
        return sw_extend_batch(
            q_tm, t_tm, qlen, tlen, h0, max_ins, max_del, params=params
        )

    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data")) + (P("data"),) * 5,
        out_specs=jax.tree.map(lambda _: P("data"), dict(
            score=0, qle=0, tle=0, gtle=0, gscore=0, max_off=0, w=0
        )),
    ))


def sw_extend_dp(mesh: Mesh, q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
                 params: ExtendParams = DEFAULT_EXTEND_PARAMS):
    """Banded seed extension, tasks sharded over "data"."""
    return _extend_dp_fn(mesh, params)(
        q_tm, t_tm, qlen, tlen, h0, max_ins, max_del
    )


@functools.lru_cache(maxsize=None)
def _sw_device_dp_fn(mesh: Mesh, strategy: int, params: SWParams):
    from acc_genomics_tpu.ops.sw.walker import sw_align_device

    def local(r, a, rl, al):
        return sw_align_device(r, a, rl, al, strategy, params)

    return jax.jit(jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, "data"), P(None, "data"), P("data"), P("data")),
        out_specs=P(None, "data"),
        # the walker's loop carries start as shard-invariant constants
        check_vma=False,
    ))


def sw_device_dp(mesh: Mesh, ref_tm, alt_tm, reflen, altlen, strategy: int,
                 params: SWParams = DEFAULT_SW_PARAMS):
    """Full SW device path (XLA fill + device walker) sharded over
    "data"; returns the walker's packed element buffer, lane-sharded."""
    return _sw_device_dp_fn(mesh, strategy, params)(
        ref_tm, alt_tm, reflen, altlen
    )

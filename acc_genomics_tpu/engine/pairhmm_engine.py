"""Single-device PairHMM engine: bucket -> pack -> device kernel -> epilogue.

The accelerator redesign of the reference's production dispatch path
(FalconPairHMM::computePairhmm, pairhmm/xlnx/host/FalconPairHMM.cpp:571-664):

* segmentation + length sorting  -> shape bucketing (engine/bucketing.py)
* PU load balancing              -> haplotype-length-sorted lanes, one
  GPU thread per pair, per-block trip counts (ops/pairhmm/kernel.py)
* worthFPGA cost model           -> small dict-path batches run on the
  native host engine instead of the accelerator
* fp32 underflow (< MIN_ACCEPTED) -> per-pair fp64 recompute with the
  NumPy oracle on host, exactly the AVX-double recompute contract
  (FalconPairHMM.cpp:634-656, PairHMMWorker.cpp:157-197)
* final output: log10(result) - LOG10_INITIAL_CONSTANT per pair.

jit caching per bucket shape replaces the reference's per-board kernel
geometry; the first call on a new shape pays one compile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from acc_genomics_tpu.config import PairHMMConfig
from acc_genomics_tpu.engine.bucketing import plan_buckets
from acc_genomics_tpu import native
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.kernel import (
    kernel_for_platform,
    pairhmm_forward_from_quals,
    pairhmm_forward_from_quals_packed,
)
from acc_genomics_tpu.ops.pairhmm.pack import (
    LANES,
    pack_pairhmm_batch,
    pack_pairhmm_quals,
)
from acc_genomics_tpu.utils.timer import Timer


@dataclasses.dataclass
class DispatchCostModel:
    """Host-vs-device dispatch gate — the worthFPGA analog
    (/root/reference/pairhmm/xlnx/host/FalconPairHMM.cpp:112-139, which
    compares measured AVX time against PCIe + prep + compute + recompute
    with live constants).  Predicted times:

        host_s(cells)          = cells / (host_gcups * cores)
        device_s(cells, bytes) = fixed_s + cells / device_gcups
                                         + bytes / link_gb_s

    Every constant is either given or measured on this host and device by
    :meth:`calibrate`; none is assumed.
    """

    host_gcups: float  # native forward rate per core
    device_gcups: float  # device forward rate
    link_gb_s: float  # sustained host-to-device rate
    fixed_s: float  # per-call dispatch + sync overhead
    cores: int = 1

    def host_s(self, cells: int) -> float:
        return cells / (self.host_gcups * max(self.cores, 1)) / 1e9

    def device_s(self, cells: int, nbytes: int) -> float:
        return (
            self.fixed_s
            + cells / self.device_gcups / 1e9
            + nbytes / (self.link_gb_s * 1e9)
        )

    def device_worthwhile(self, cells: int, nbytes: int) -> bool:
        return self.device_s(cells, nbytes) < self.host_s(cells)

    @classmethod
    def calibrate(cls, engine: "PairHMMEngine") -> "DispatchCostModel":
        """Measure every constant on this host and ``engine``'s device:
        the native forward rate on a 64-pair batch, one 4 MB upload, and
        the engine's device path on a small and a large batch (their
        difference gives the rate, the small one the fixed cost)."""
        import os
        import time

        from acc_genomics_tpu.io.synth import gen_pairhmm_pairs

        def timed(fn):
            fn()  # warm (compiles on the device path)
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        rng = np.random.default_rng(0)
        small = gen_pairhmm_pairs(rng, 64, max_read_len=120, max_hap_len=300)
        large = gen_pairhmm_pairs(rng, 1024, max_read_len=120, max_hap_len=300)
        cells_s = sum(len(t["rs"]) * len(t["hap"]) for t in small)
        cells_l = sum(len(t["rs"]) * len(t["hap"]) for t in large)
        host = cells_s / timed(lambda: native.pairhmm_forward(small)) / 1e9
        buf = np.zeros(4 << 20, np.uint8)
        link = buf.size / timed(
            lambda: jax.device_put(buf, engine.device).block_until_ready()
        ) / 1e9
        saved = engine.min_device_cells, engine.cost_model
        engine.min_device_cells, engine.cost_model = 0, None
        try:
            t_s = timed(lambda: engine.compute_pairs(small))
            t_l = timed(lambda: engine.compute_pairs(large))
        finally:
            engine.min_device_cells, engine.cost_model = saved
        dev = (cells_l - cells_s) / max(t_l - t_s, 1e-9) / 1e9
        return cls(
            host_gcups=host, device_gcups=dev, link_gb_s=link,
            fixed_s=max(t_s - cells_s / dev / 1e9, 0.0),
            cores=os.cpu_count() or 1,
        )


class PairHMMEngine:
    """Computes log10 P(read | hap) for batches of (read, hap) pairs.

    The device forward is :func:`kernel_for_platform` of the device: the
    Pallas kernel on a GPU, the XLA row scan on the CPU.
    """

    def __init__(
        self,
        config: PairHMMConfig = PairHMMConfig(),
        device: Optional[jax.Device] = None,
        mesh=None,
    ):
        self.config = config
        self.device = device or jax.devices()[0]
        self.kernel = kernel_for_platform(self.device.platform)
        # optional device mesh: batches shard over its "data" axis
        # (the Blaze multi-worker tiling analog, shard_map-based)
        self.mesh = mesh
        self._data_size = int(mesh.shape["data"]) if mesh is not None else 1
        self.ctx32 = PairHMMContext(np.float32)
        # dispatch gate (worthFPGA analog) of the dict path.  Two tiers:
        # the static cell threshold (always on, zero-cost), and — when a
        # DispatchCostModel is installed via set_cost_model()/
        # calibrate_dispatch() — the full predicted-time comparison with
        # measured constants, matching FalconPairHMM.cpp:112-139.
        self.min_device_cells = 2_000_000
        self.cost_model: Optional[DispatchCostModel] = None
        self.stats = {"pairs": 0, "recomputed": 0, "cells": 0, "device_calls": 0}

    # -- dispatch calibration ---------------------------------------------

    def set_cost_model(self, model: Optional[DispatchCostModel]):
        """Install (or clear) the calibrated dispatch gate."""
        self.cost_model = model

    def calibrate_dispatch(self) -> DispatchCostModel:
        """Measure the gate's constants on this host and device
        (DispatchCostModel.calibrate) and install it."""
        self.cost_model = DispatchCostModel.calibrate(self)
        return self.cost_model

    # -- core ------------------------------------------------------------

    def _launch_bucket(self, tcs: Sequence[dict], rows: int, cols: int):
        """Pack + enqueue one bucket; returns (pack, device future).

        Dispatch is async (JAX) so packing of the next bucket overlaps
        device compute of this one — the analog of the reference's
        boost-threaded double-buffered host pipeline
        (bwa-sw/intel/aocl/src/main_cl.cpp KernelWorker).
        """
        # byte-plane upload (~1/8 the bytes of coefficient planes; the
        # device expands them).  Haplen-sorted lanes keep each kernel
        # block's column count tight (the reference's sortReads,
        # FalconPairHMM.cpp:268)
        pack = pack_pairhmm_quals(
            tcs, rows=rows, cols=cols, sort_by_haplen=True,
            lane_multiple=LANES * self._data_size,
        )
        self.stats["cells"] += pack.cells
        self.stats["device_calls"] += 1
        planes = (pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext,
                  pack.rslen, pack.haplen)
        if self.mesh is None:
            res = pairhmm_forward_from_quals(
                *[jax.device_put(a, self.device) for a in planes],
                np.float32(self.ctx32.initial_constant), kernel=self.kernel,
            )
            return pack, res
        # lanes shard over "data": each device gets only its own lanes
        from acc_genomics_tpu.parallel.sharded import (
            pairhmm_forward_dp_from_quals,
            shard_lanes,
        )

        res = pairhmm_forward_dp_from_quals(
            self.mesh, *shard_lanes(self.mesh, planes),
            initial_constant=float(self.ctx32.initial_constant),
            kernel=self.kernel,
        )
        return pack, res

    def _run_bucket(self, tcs: Sequence[dict], rows: int, cols: int) -> np.ndarray:
        pack, res = self._launch_bucket(tcs, rows, cols)
        return pack.unsort(np.asarray(res))

    def compute_pairs(self, testcases: Sequence[dict]) -> np.ndarray:
        """log10-likelihood for each testcase dict (rs,q,i,d,c,hap).

        Mirrors computePairhmm semantics: fp32 on device, fp64 host
        recompute for results below MIN_ACCEPTED.
        """
        n = len(testcases)
        if n == 0:
            return np.zeros(0, np.float64)
        self.stats["pairs"] += n
        read_lens = [len(t["rs"]) for t in testcases]
        hap_lens = [len(t["hap"]) for t in testcases]

        # worthFPGA-analog cost gate (FalconPairHMM.cpp:112-139): tiny
        # workloads skip the accelerator round trip and run on the native
        # C++ host engine (the reference's AVX-path role).  With a
        # calibrated cost model the gate compares PREDICTED times
        # (host cells/rate vs fixed + compute + upload) — see
        # DispatchCostModel; otherwise the static cell threshold applies.
        total_cells = sum(r * h for r, h in zip(read_lens, hap_lens))
        if self.cost_model is not None:
            # quals upload ships 5 byte planes per read + 1 per hap
            est_bytes = 5 * sum(read_lens) + sum(hap_lens) + 12 * n
            use_host = not self.cost_model.device_worthwhile(
                total_cells, est_bytes
            )
        else:
            use_host = total_cells < self.min_device_cells
        if use_host:
            host = native.pairhmm_forward(testcases, np.float32)
            self.stats["host_native_calls"] = (
                self.stats.get("host_native_calls", 0) + 1
            )
            self.stats["cells"] += total_cells
            return self._epilogue(testcases, host)

        # outliers beyond the largest bucket run on the host engine, like
        # the reference's per-segment AVX fallback (computePairhmmFalcon
        # `violate` -> computePairhmmAVXSegment, FalconPairHMM.cpp:609-611).
        # On a mesh with a seq axis, pairs whose HAPLOTYPE (not read)
        # exceeds the bucket cap route to the DP x SP shard instead — the
        # collective-based replacement for the reference's host-side
        # segmentation of oversized haps (PairHMMFpga.cpp:284-332).
        seq_size = int(self.mesh.shape["seq"]) if self.mesh is not None else 1
        sp_cap = self.config.max_hap_len * seq_size
        fits, sp_idx, over = [], [], []
        for k in range(n):
            if (
                read_lens[k] <= self.config.max_read_len
                and hap_lens[k] <= self.config.max_hap_len
            ):
                fits.append(k)
            elif (
                seq_size > 1
                and read_lens[k] <= self.config.max_read_len
                and hap_lens[k] <= sp_cap
            ):
                sp_idx.append(k)
            else:
                over.append(k)
        raw = np.zeros(n, np.float32)
        host_thread = None
        if over:
            # host fallback on a worker thread, concurrent with the device
            # bucket launches below (the reference worker's CPU-region
            # boost::thread, PairHMMWorker.cpp:201-270; the native forward
            # releases the GIL)
            import threading

            self.stats["host_fallback"] = self.stats.get("host_fallback", 0) + len(over)

            def host_work():
                try:
                    raw[over] = self._host_forward(
                        [testcases[k] for k in over]
                    )
                except BaseException as e:  # re-raised after join
                    host_err.append(e)

            host_err = []
            host_thread = threading.Thread(target=host_work)
            host_thread.start()

        plan = plan_buckets(
            [read_lens[k] for k in fits],
            [hap_lens[k] for k in fits],
            self.config.read_buckets,
            self.config.hap_buckets,
        )
        fits_arr = np.asarray(fits, dtype=np.int64)
        with Timer("pairhmm.device"):
            # launch every bucket before collecting any: packing bucket k+1
            # overlaps device compute of bucket k (async dispatch)
            pending = []
            if sp_idx:
                # DP x SP: hap columns shard over "seq" (must divide by
                # seq_size); pack to the next seq-aligned column count
                from acc_genomics_tpu.parallel.sharded import (
                    pairhmm_forward_dpsp,
                    shard_lanes,
                )

                self.stats["sp_pairs"] = (
                    self.stats.get("sp_pairs", 0) + len(sp_idx)
                )
                max_hl = max(hap_lens[k] for k in sp_idx)
                cols_sp = -(-max_hl // (seq_size * LANES)) * seq_size * LANES
                rows_sp = self.config.read_buckets[-1]
                sp_pack = pack_pairhmm_batch(
                    [testcases[k] for k in sp_idx],
                    rows=rows_sp, cols=cols_sp, dtype=np.float32,
                    lane_multiple=self._data_size,
                )
                res = pairhmm_forward_dpsp(
                    self.mesh, *shard_lanes(self.mesh, sp_pack.arrays())
                )
                pending.append((np.asarray(sp_idx, np.int64), sp_pack, res))
            for (rows, cols), idxs in plan.groups.items():
                max_pairs = self.config.max_batch_pairs
                for lo in range(0, len(idxs), max_pairs):
                    chunk = fits_arr[idxs[lo : lo + max_pairs]]
                    pack, res = self._launch_bucket(
                        [testcases[i] for i in chunk], rows, cols
                    )
                    pending.append((chunk, pack, res))
            # ONE D2H transfer for every bucket: concatenate the
            # per-bucket results on the device first
            if pending:
                allres = np.asarray(
                    jnp.concatenate([res for _, _, res in pending])
                )
                col = 0
                for chunk, pack, res in pending:
                    w = res.shape[0]
                    raw[chunk] = pack.unsort(allres[col : col + w])
                    col += w
        if host_thread is not None:
            host_thread.join()
            if host_err:
                raise host_err[0]
        return self._epilogue(testcases, raw)

    def _host_forward(self, tcs) -> np.ndarray:
        """fp32 forward on the native host engine."""
        return native.pairhmm_forward(tcs, np.float32)

    def _epilogue(self, testcases, raw: np.ndarray) -> np.ndarray:
        """log10 conversion + fp64 recompute of fp32 underflows (the
        AVX-double recompute contract, FalconPairHMM.cpp:634-656)."""
        n = len(testcases)
        out = np.empty(n, np.float64)
        ok = raw >= np.float32(self.config.min_accepted)
        with np.errstate(divide="ignore"):
            out[ok] = np.log10(raw[ok].astype(np.float64)) - np.float64(
                self.ctx32.log10_initial_constant
            )
        bad = np.flatnonzero(~ok)
        self.stats["recomputed"] += len(bad)
        if len(bad):
            ctx64 = PairHMMContext(np.float64)
            with Timer("pairhmm.recompute64"):
                r64 = native.pairhmm_forward(
                    [testcases[i] for i in bad], np.float64
                )
                out[bad] = np.log10(r64) - np.float64(
                    ctx64.log10_initial_constant
                )
        return out

    # -- flat ingestion path ---------------------------------------------

    def compute_pairs_flat(
        self,
        rs: np.ndarray, q: np.ndarray, i: np.ndarray, d: np.ndarray,
        c: np.ndarray, lens: np.ndarray,
        hap: np.ndarray, hlens: np.ndarray,
        offs: Optional[np.ndarray] = None,
        hoffs: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """log10-likelihoods from concatenated (wire-format) inputs."""
        return self._flat_finalize(
            *self._flat_launch(rs, q, i, d, c, lens, hap, hlens, offs, hoffs)
        )

    def _flat_launch(
        self, rs, q, i, d, c, lens, hap, hlens, offs=None, hoffs=None
    ):
        """Pack + enqueue all buckets of one flat batch WITHOUT fetching;
        the returned state finalizes via _flat_finalize.  See
        compute_pairs_flat for semantics.

        The zero-Python-per-pair path: rs/q/i/d/c are the per-read byte
        streams concatenated in pair order (lens gives each pair's read
        length), hap likewise (hlens).  This is the reference's own shape
        — its host interface ships exactly these concatenated buffers
        (pairhmm/interface/PairHMMHostInterface.cpp:175-255) and packs
        them in C++ (pack_fpga_input).  Bucketing, sorting, packing, and
        the fp64 recompute all run on flat arrays; per-pair Python loops
        never run.  A mesh engine takes the dict path.
        """
        from acc_genomics_tpu.utils.convert import HAP_PAD

        lens = np.asarray(lens, np.int32)
        hlens = np.asarray(hlens, np.int32)
        n = len(lens)
        if n == 0:
            return ("done", np.zeros(0, np.float64)), None
        if offs is None:
            offs = np.zeros(n, np.int64)
            if n > 1:
                np.cumsum(lens[:-1].astype(np.int64), out=offs[1:])
        else:
            offs = np.ascontiguousarray(offs, np.int64)
        if hoffs is None:
            hoffs = np.zeros(n, np.int64)
            if n > 1:
                np.cumsum(hlens[:-1].astype(np.int64), out=hoffs[1:])
        else:
            hoffs = np.ascontiguousarray(hoffs, np.int64)
        if self.mesh is not None:
            # the mesh shards dict-path packs over "data"
            tcs = [
                dict(
                    rs=rs[offs[k] : offs[k] + lens[k]],
                    q=q[offs[k] : offs[k] + lens[k]],
                    i=i[offs[k] : offs[k] + lens[k]],
                    d=d[offs[k] : offs[k] + lens[k]],
                    c=c[offs[k] : offs[k] + lens[k]],
                    hap=hap[hoffs[k] : hoffs[k] + hlens[k]],
                )
                for k in range(n)
            ]
            return ("done", self.compute_pairs(tcs)), None

        self.stats["pairs"] += n
        rs = np.ascontiguousarray(rs, np.uint8)
        q = np.ascontiguousarray(q, np.uint8)
        i = np.ascontiguousarray(i, np.uint8)
        d = np.ascontiguousarray(d, np.uint8)
        c = np.ascontiguousarray(c, np.uint8)
        hap = np.ascontiguousarray(hap, np.uint8)
        self.stats["cells"] += int((lens.astype(np.int64) * hlens).sum())

        rbuckets = np.asarray(self.config.read_buckets, np.int32)
        cbuckets = np.asarray(self.config.hap_buckets, np.int32)
        # bucket of each pair (vectorized); oversize -> -1
        rb = np.searchsorted(rbuckets - 1, lens, side="left")
        cb = np.searchsorted(cbuckets, hlens, side="left")
        over = (rb >= len(rbuckets)) | (cb >= len(cbuckets))
        rb = np.where(over, -1, rb)

        raw = np.zeros(n, np.float32)
        host_thread = None
        over_idx = np.flatnonzero(over)
        if len(over_idx):
            import threading

            self.stats["host_fallback"] = (
                self.stats.get("host_fallback", 0) + len(over_idx)
            )

            def host_work():
              try:
                out = np.empty(len(over_idx), np.float32)
                lib = native.get_lib()
                lib.pairhmm_forward_batch_f32(
                    rs, q, i, d, c,
                    np.ascontiguousarray(offs[over_idx]),
                    np.ascontiguousarray(lens[over_idx]),
                    hap, np.ascontiguousarray(hoffs[over_idx]),
                    np.ascontiguousarray(hlens[over_idx]), len(over_idx),
                    np.ascontiguousarray(self.ctx32.ph2pr, np.float32),
                    np.ascontiguousarray(
                        self.ctx32.match_to_match, np.float32
                    ),
                    np.float32(self.ctx32.initial_constant), out,
                )
                raw[over_idx] = out
              except BaseException as e:  # re-raised after join
                host_err.append(e)

            host_err = []
            host_thread = threading.Thread(target=host_work)
            host_thread.start()

        code = rb * (len(cbuckets) + 1) + cb  # group id per pair
        with Timer("pairhmm.device"):
            pending = []
            stage_q = []  # byte-plane groups: packed on host, uploaded ONCE
            for g in np.unique(code[~over]) if (~over).any() else []:
                idxs = np.flatnonzero(code == g)
                gr, gc = divmod(int(g), len(cbuckets) + 1)
                rows = int(rbuckets[gr])
                cols = int(cbuckets[gc])
                max_pairs = self.config.max_batch_pairs
                for lo in range(0, len(idxs), max_pairs):
                    sel = idxs[lo : lo + max_pairs]
                    # haplen-sorted lanes keep per-block trip counts tight
                    sel = sel[np.argsort(-hlens[sel], kind="stable")]
                    # power-of-two lane ladder: batch-to-batch bucket-mix
                    # jitter must not mint fresh jit shapes (pad lanes are
                    # inert: len 0, and sort last so no block's trip
                    # counts grow)
                    bp = LANES
                    while bp < len(sel):
                        bp *= 2
                    g_lens = np.zeros(bp, np.int32)
                    g_hlens = np.zeros(bp, np.int32)
                    g_offs = np.zeros(bp, np.int64)
                    g_hoffs = np.zeros(bp, np.int64)
                    g_lens[: len(sel)] = lens[sel]
                    g_hlens[: len(sel)] = hlens[sel]
                    g_offs[: len(sel)] = offs[sel]
                    g_hoffs[: len(sel)] = hoffs[sel]
                    packed = native.pairhmm_pack_quals_flat(
                        rs, q, i, d, c, g_offs, g_lens,
                        hap, g_hoffs, g_hlens, rows, cols, HAP_PAD,
                    )
                    big, meta = self._quals_pack_arrays(
                        packed, g_lens, g_hlens
                    )
                    stage_q.append((sel, big, meta, rows))
            if stage_q:
                # ONE uint8 + ONE int32 upload for the whole batch; each
                # bucket slices its planes out on the device
                du8 = jax.device_put(
                    np.concatenate([b.ravel() for _, b, _, _ in stage_q]),
                    self.device,
                )
                dmi = jax.device_put(
                    np.concatenate([m.ravel() for _, _, m, _ in stage_q]),
                    self.device,
                )
                self.stats["h2d_bytes"] = (
                    self.stats.get("h2d_bytes", 0) + du8.size + 4 * dmi.size
                )
                o = mo = 0
                for sel, b, m, rows in stage_q:
                    bb = jax.lax.slice(du8, (o,), (o + b.size,)).reshape(b.shape)
                    mm = jax.lax.slice(dmi, (mo,), (mo + m.size,)).reshape(m.shape)
                    o += b.size
                    mo += m.size
                    res = self._launch_quals_dev(bb, mm, rows)
                    self.stats["device_calls"] += 1
                    pending.append((sel, res))
            # concatenate per-bucket results ON DEVICE now (async); the
            # single D2H happens in _flat_finalize
            allres_dev = (
                jnp.concatenate([r for _, r in pending]) if pending else None
            )
        state = (
            "pending", rs, q, i, d, c, offs, lens, hap, hoffs, hlens,
            raw, pending, allres_dev, host_thread,
            host_err if host_thread is not None else [],
        )
        return state, None

    def _flat_finalize(self, state, _):
        """Fetch + scatter + fp64 epilogue for a _flat_launch state."""
        if state[0] == "done":
            return state[1]
        (_, rs, q, i, d, c, offs, lens, hap, hoffs, hlens,
         raw, pending, allres_dev, host_thread, host_err) = state
        if allres_dev is not None:
            allres = np.asarray(allres_dev)
            self.stats["d2h_bytes"] = (
                self.stats.get("d2h_bytes", 0) + allres.nbytes
            )
            col = 0
            for sel, res in pending:
                w = res.shape[0]
                raw[sel] = allres[col : col + len(sel)]
                col += w
        if host_thread is not None:
            host_thread.join()
            if host_err:
                raise host_err[0]
        return self._epilogue_flat(
            rs, q, i, d, c, offs, lens, hap, hoffs, hlens, raw
        )

    def _quals_pack_arrays(self, packed, g_lens, g_hlens):
        """Host half of a byte-plane bucket launch: the six uint8 planes
        as ONE contiguous (5*rows + cols, bp) buffer plus the (2, bp)
        int32 read / haplotype lengths."""
        oq, oi, od, oc, ors, hap_ext = packed
        rows = ors.shape[0]
        bp = ors.shape[1]
        big = oq.base if oq.base is not None else None
        if big is None or big.shape != (5 * rows + hap_ext.shape[0], bp):
            big = np.concatenate([oq, oi, od, oc, ors, hap_ext])
        # ship only the first `cols` hap rows: hlens <= cols, so the last
        # `rows` rows of the (rows+cols, bp) hap_ext plane are pure pad —
        # _launch_quals_dev re-appends them on device
        cols = hap_ext.shape[0] - rows
        big = big[: 5 * rows + cols]
        return big, np.stack([g_lens, g_hlens]).astype(np.int32)

    def _launch_quals_dev(self, big_dev, meta_dev, rows):
        """Device half: enqueue the forward on already-uploaded (or
        device-sliced) big/meta arrays.  big_dev carries only `cols` hap
        rows (the trailing `rows` pad rows are appended here on device —
        see _quals_pack_arrays)."""
        from acc_genomics_tpu.utils.convert import HAP_PAD

        big_dev = jnp.concatenate(
            [
                big_dev,
                jnp.full((rows, big_dev.shape[1]), HAP_PAD, jnp.uint8),
            ]
        )
        return pairhmm_forward_from_quals_packed(
            big_dev, meta_dev,
            rows=rows,
            initial_constant=float(self.ctx32.initial_constant),
            kernel=self.kernel,
        )

    def _epilogue_flat(
        self, rs, q, i, d, c, offs, lens, hap, hoffs, hlens, raw
    ) -> np.ndarray:
        """log10 + fp64 recompute on flat arrays (no per-pair dicts)."""
        n = len(lens)
        out = np.empty(n, np.float64)
        ok = raw >= np.float32(self.config.min_accepted)
        with np.errstate(divide="ignore"):
            out[ok] = np.log10(raw[ok].astype(np.float64)) - np.float64(
                self.ctx32.log10_initial_constant
            )
        bad = np.flatnonzero(~ok)
        self.stats["recomputed"] += len(bad)
        if len(bad):
            ctx64 = PairHMMContext(np.float64)
            r64 = np.empty(len(bad), np.float64)
            with Timer("pairhmm.recompute64"):
                lib = native.get_lib()
                lib.pairhmm_forward_batch_f64(
                    rs, q, i, d, c,
                    np.ascontiguousarray(offs[bad]),
                    np.ascontiguousarray(lens[bad]),
                    hap, np.ascontiguousarray(hoffs[bad]),
                    np.ascontiguousarray(hlens[bad]), len(bad),
                    np.ascontiguousarray(ctx64.ph2pr, np.float64),
                    np.ascontiguousarray(ctx64.match_to_match, np.float64),
                    np.float64(ctx64.initial_constant), r64,
                )
                out[bad] = np.log10(r64) - np.float64(
                    ctx64.log10_initial_constant
                )
        return out

    def compute_pairs_flat_stream(self, batches) -> list:
        """Pipelined multi-batch flat computation: every batch's buckets
        are packed and LAUNCHED before any result is fetched, so host
        packing of batch k+1 overlaps device compute of batch k and the
        final D2H is one transfer per batch — the steady-state streaming
        form of the reference's double-buffered host pipeline
        (bwa-sw/intel/aocl KernelWorker).

        batches: iterable of (rs, q, i, d, c, lens, hap, hlens) tuples.
        Returns a list of per-batch log10-likelihood arrays.

        At most two batches are in flight: a depth-2 window already
        overlaps pack(k+1) with device(k).
        """
        import time as _t

        states: list = []
        outs: list = []
        t_launch = t_final = 0.0
        for b in batches:
            t0 = _t.perf_counter()
            states.append(self._flat_launch(*b))
            t_launch += _t.perf_counter() - t0
            if len(states) > 1:  # depth-2 window: at most 2 in flight
                t0 = _t.perf_counter()
                outs.append(self._flat_finalize(*states.pop(0)))
                t_final += _t.perf_counter() - t0
        while states:
            t0 = _t.perf_counter()
            outs.append(self._flat_finalize(*states.pop(0)))
            t_final += _t.perf_counter() - t0
        # phase accounting for the streamed-e2e anatomy (where does the
        # wall go: host pack+enqueue vs fetch-side wait).  Cumulative,
        # like the byte counters; callers diff around a run.
        self.stats["stream_launch_s"] = (
            self.stats.get("stream_launch_s", 0.0) + t_launch
        )
        self.stats["stream_finalize_s"] = (
            self.stats.get("stream_finalize_s", 0.0) + t_final
        )
        return outs

    def compute_matrix_flat(
        self, rs, q, i, d, c, read_lens, hap, hap_lens
    ) -> np.ndarray:
        """All read x hap likelihoods from flat per-read / per-hap streams.

        The cross product shares the underlying byte streams — pair
        (r, h) is addressed by (read offset r, hap offset h), so no data
        is replicated on the host (the reference tiles the same way,
        PairHMMWorker.cpp:217-222).
        """
        read_lens = np.asarray(read_lens, np.int32)
        hap_lens = np.asarray(hap_lens, np.int32)
        n_r, n_h = len(read_lens), len(hap_lens)
        roffs = np.zeros(n_r, np.int64)
        hoffs0 = np.zeros(n_h, np.int64)
        if n_r > 1:
            np.cumsum(read_lens[:-1].astype(np.int64), out=roffs[1:])
        if n_h > 1:
            np.cumsum(hap_lens[:-1].astype(np.int64), out=hoffs0[1:])
        res = self.compute_pairs_flat(
            rs, q, i, d, c,
            np.repeat(read_lens, n_h), hap, np.tile(hap_lens, n_r),
            offs=np.repeat(roffs, n_h), hoffs=np.tile(hoffs0, n_r),
        )
        return res.reshape(n_r, n_h)

    def compute_matrix(self, reads: Sequence[dict], haps: Sequence[np.ndarray]) -> np.ndarray:
        """All read x hap likelihoods, read-major (the reference driver's
        pairhmmInput -> likelihoodData layout, pairhmm/host/main.cpp)."""
        tcs = [
            dict(hap=h, **r)
            for r in reads
            for h in haps
        ]
        return self.compute_pairs(tcs).reshape(len(reads), len(haps))

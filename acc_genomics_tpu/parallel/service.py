"""Engine service: client/daemon offload over TCP.

The device-side replacement for the reference's Blaze layer
(pairhmm/client/* + pairhmm/task/*): an application process serialises
batches to a daemon that owns the accelerator; the daemon keeps
device-resident state (the FM-index scratch-cache analog) across
requests; the client falls back to local CPU compute when no daemon is
reachable (PairHMMClient::compute, pairhmm/client/PairHMMClient.cpp:69-85).

Wire format: one frame per message —
    u32 opcode | u64 payload length | payload
payload = npz archive of named numpy arrays (allow_pickle=False both
ways; no code crosses the wire).  In multi-host setups jax.distributed
owns cross-host collectives; this service covers the reference's other
topology — remote CPU clients feeding an accelerator daemon.

The daemon owns its card: it is the one JAX process on that GPU (a JAX
process reserves most of the card's memory when it starts, so a second
one would fail), and clients never import JAX against the same card.
"""

from __future__ import annotations

import io
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

OP_PAIRHMM = 1
OP_SMEM = 2
OP_SW = 3
OP_LOAD_REF = 4
OP_EXTEND = 5
OP_SHUTDOWN = 99

_EXTEND_FIELDS = ("qBeg", "qEnd", "rBeg", "rEnd", "score", "trueScore", "width")

_HDR = struct.Struct("<IQ")


def _pack(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _send(sock: socket.socket, op: int, arrays: Dict[str, np.ndarray]):
    payload = _pack(arrays)
    sock.sendall(_HDR.pack(op, len(payload)) + payload)


def _recv(sock: socket.socket):
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = sock.recv(_HDR.size - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    op, ln = _HDR.unpack(hdr)
    payload = b""
    while len(payload) < ln:
        chunk = sock.recv(min(1 << 20, ln - len(payload)))
        if not chunk:
            raise ConnectionError("peer closed")
        payload += chunk
    return op, _unpack(payload)


def _encode_ragged(arrs: List[np.ndarray], dtype=np.uint8):
    lens = np.array([len(a) for a in arrs], np.int64)
    flat = (
        np.concatenate([np.asarray(a, dtype) for a in arrs])
        if arrs
        else np.zeros(0, dtype)
    )
    return flat, lens


def _decode_ragged(flat: np.ndarray, lens: np.ndarray) -> List[np.ndarray]:
    out = []
    off = 0
    for ln in lens:
        out.append(flat[off : off + int(ln)])
        off += int(ln)
    return out


class EngineServer:
    """Daemon owning one GenomicsEngine (and thus the accelerator)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, engine=None):
        if engine is None:
            from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine

            engine = GenomicsEngine()
        self.engine = engine
        # one engine, many client threads: requests serialize through this
        # lock — the Blaze daemon executes tasks one at a time per
        # accelerator too (pairhmm/task/xlnx/PairHMMTask.cpp), and the
        # engine's jit caches / stats / index state are not thread-safe
        self._engine_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        op, req = _recv(self.request)
                    except ConnectionError:
                        return
                    if op == OP_SHUTDOWN:
                        _send(self.request, op, {})
                        outer._server.shutdown()
                        return
                    try:
                        with outer._engine_lock:
                            resp = outer._dispatch(op, req)
                        _send(self.request, op, resp)
                    except Exception as e:  # report, keep serving
                        _send(
                            self.request, 0,
                            {"error": np.frombuffer(str(e).encode(), np.uint8)},
                        )

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _dispatch(self, op: int, req: Dict[str, np.ndarray]):
        if op == OP_LOAD_REF:
            if "prefix" in req:
                # load a persisted BWA-format index from the daemon's disk
                # (the scratch-cache / ocl_init pattern: big read-only state
                # lives with the accelerator owner, not on the wire)
                from acc_genomics_tpu.io.bwa_index import load_bwa_index

                prefix = req["prefix"].tobytes().decode()
                fm, _ = load_bwa_index(prefix)
                self.engine.set_index(fm)
            else:
                self.engine.load_reference(req["genome"])
            return {"ok": np.array([1])}
        if op == OP_PAIRHMM:
            # the wire format IS the flat ingestion format (concatenated
            # byte streams + length vectors): feed it straight to the
            # zero-per-pair flat matrix path
            lik = self.engine.pairhmm.compute_matrix_flat(
                req["rs"], req["q"], req["i"], req["d"], req["c"],
                req["read_lens"].astype(np.int32),
                req["haps"], req["hap_lens"].astype(np.int32),
            )
            return {"lik": lik}
        if op == OP_SMEM:
            reads = _decode_ragged(req["reads"], req["read_lens"])
            ivs = self.engine.smem_collect(reads)
            counts = np.array([len(v) for v in ivs], np.int64)
            flat = np.array(
                [
                    [iv["x0"], iv["x1"], iv["s"], iv["start"], iv["end"]]
                    for v in ivs
                    for iv in v
                ],
                np.int64,
            ).reshape(-1, 5)
            return {"counts": counts, "intervals": flat}
        if op == OP_SW:
            refs = _decode_ragged(req["refs"], req["ref_lens"])
            alts = _decode_ragged(req["alts"], req["alt_lens"])
            strategy = int(req["strategy"][0])
            aligned = self.engine.sw.align(refs, alts, strategy)
            counts = np.array([len(cig) for cig, _ in aligned], np.int64)
            elems = np.array(
                [[ln, st] for cig, _ in aligned for ln, st in cig], np.int64
            ).reshape(-1, 2)
            offsets = np.array([off for _, off in aligned], np.int64)
            return {"counts": counts, "elems": elems, "offsets": offsets}
        if op == OP_EXTEND:
            reads = _decode_ragged(req["reads"], req["read_lens"])
            rseqs = _decode_ragged(req["rseqs"], req["rseq_lens"])
            seeds = [
                dict(read=r, rseq=t, qbeg=int(qb), rbeg_off=int(ro), len=int(sl))
                for r, t, qb, ro, sl in zip(
                    reads, rseqs, req["qbeg"], req["rbeg_off"], req["seed_len"]
                )
            ]
            res = self.engine.extend_seeds(seeds)
            return {
                k: np.array([int(r[k]) for r in res], np.int64)
                for k in _EXTEND_FIELDS
            }
        raise ValueError(f"unknown op {op}")

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class EngineClient:
    """Connects to a daemon; computes locally on CPU when unreachable."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, timeout: float = 5.0):
        self._sock: Optional[socket.socket] = None
        self.used_fallback = False
        try:
            self._sock = socket.create_connection((host, port), timeout=timeout)
            # requests may trigger jit compiles on the daemon; don't let the
            # connect timeout bound the compute
            self._sock.settimeout(None)
        except OSError:
            self._sock = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _local_engine(self):
        from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine

        if not hasattr(self, "_local"):
            self._local = GenomicsEngine()
        return self._local

    def pairhmm(self, reads, haps) -> np.ndarray:
        if self._sock is None:
            self.used_fallback = True
            return self._local_engine().pairhmm_matrix(reads, haps)
        req = {}
        for k in ("rs", "q", "i", "d", "c"):
            req[k], req["read_lens"] = _encode_ragged([r[k] for r in reads])
        req["haps"], req["hap_lens"] = _encode_ragged(list(haps))
        _send(self._sock, OP_PAIRHMM, req)
        op, resp = _recv(self._sock)
        if "error" in resp:
            raise RuntimeError(resp["error"].tobytes().decode())
        return resp["lik"]

    def load_reference(self, genome: np.ndarray):
        if self._sock is None:
            self.used_fallback = True
            self._local_engine().load_reference(genome)
            return
        _send(self._sock, OP_LOAD_REF, {"genome": np.asarray(genome, np.uint8)})
        _recv(self._sock)

    def load_reference_path(self, prefix: str):
        """Point the daemon at a persisted BWA-format index on ITS disk."""
        req = {"prefix": np.frombuffer(prefix.encode(), np.uint8)}
        if self._sock is None:
            from acc_genomics_tpu.io.bwa_index import load_bwa_index

            self.used_fallback = True
            fm, _ = load_bwa_index(prefix)
            self._local_engine().set_index(fm)
            return
        _send(self._sock, OP_LOAD_REF, req)
        _recv(self._sock)

    def smem(self, reads) -> List[List[dict]]:
        if self._sock is None:
            self.used_fallback = True
            return self._local_engine().smem_collect(list(reads))
        flat, lens = _encode_ragged(list(reads))
        _send(self._sock, OP_SMEM, {"reads": flat, "read_lens": lens})
        op, resp = _recv(self._sock)
        if "error" in resp:
            raise RuntimeError(resp["error"].tobytes().decode())
        out = []
        off = 0
        for n in resp["counts"]:
            rows = resp["intervals"][off : off + int(n)]
            out.append(
                [
                    dict(x0=int(r[0]), x1=int(r[1]), s=int(r[2]),
                         start=int(r[3]), end=int(r[4]))
                    for r in rows
                ]
            )
            off += int(n)
        return out

    def sw(self, refs, alts, strategy: int = 0):
        """Batch SW alignment -> [(cigar, offset)] (FalconSW over the wire)."""
        if self._sock is None:
            self.used_fallback = True
            return self._local_engine().sw.align(list(refs), list(alts), strategy)
        req = {}
        req["refs"], req["ref_lens"] = _encode_ragged(list(refs))
        req["alts"], req["alt_lens"] = _encode_ragged(list(alts))
        req["strategy"] = np.array([strategy], np.int64)
        _send(self._sock, OP_SW, req)
        op, resp = _recv(self._sock)
        if "error" in resp:
            raise RuntimeError(resp["error"].tobytes().decode())
        out = []
        off = 0
        for j, n in enumerate(resp["counts"]):
            rows = resp["elems"][off : off + int(n)]
            out.append(
                ([(int(r[0]), int(r[1])) for r in rows], int(resp["offsets"][j]))
            )
            off += int(n)
        return out

    def extend(self, seeds):
        """Batch seed extension -> resolved alignment records."""
        if self._sock is None:
            self.used_fallback = True
            return self._local_engine().extend_seeds(list(seeds))
        req = {}
        req["reads"], req["read_lens"] = _encode_ragged([s["read"] for s in seeds])
        req["rseqs"], req["rseq_lens"] = _encode_ragged([s["rseq"] for s in seeds])
        req["qbeg"] = np.array([s["qbeg"] for s in seeds], np.int64)
        req["rbeg_off"] = np.array([s["rbeg_off"] for s in seeds], np.int64)
        req["seed_len"] = np.array([s["len"] for s in seeds], np.int64)
        _send(self._sock, OP_EXTEND, req)
        op, resp = _recv(self._sock)
        if "error" in resp:
            raise RuntimeError(resp["error"].tobytes().decode())
        n = len(seeds)
        return [
            {k: int(resp[k][j]) for k in _EXTEND_FIELDS} for j in range(n)
        ]

    def shutdown_server(self):
        if self._sock is not None:
            _send(self._sock, OP_SHUTDOWN, {})
            self._sock.close()
            self._sock = None

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def main(argv=None):
    """Daemon entrypoint: `python -m acc_genomics_tpu.parallel.service`.

    The runnable counterpart of the reference's Blaze daemon started from
    a protobuf conf (pairhmm/xlnx.conf): a JSON config selects bind
    address, engine geometry, and an optional persisted index to preload.
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description="acc_genomics_tpu engine daemon")
    ap.add_argument("--conf", help="JSON daemon config file")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)

    host, port, index_prefix = "127.0.0.1", 0, None
    engine = None
    if args.conf:
        with open(args.conf) as f:
            raw = json.load(f)
        host = raw.pop("host", host)
        port = raw.pop("port", port)
        index_prefix = raw.pop("index_prefix", None)
        engine_conf = raw.pop("engine", None)
        if raw:
            raise ValueError(f"unknown daemon config keys: {sorted(raw)}")
        if engine_conf is not None:
            from acc_genomics_tpu.config import engine_config_from_dict
            from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine

            engine = GenomicsEngine(engine_config_from_dict(engine_conf))
    if args.host is not None:
        host = args.host
    if args.port is not None:
        port = args.port

    server = EngineServer(host=host, port=port, engine=engine)
    if index_prefix:
        from acc_genomics_tpu.io.bwa_index import load_bwa_index

        fm, _ = load_bwa_index(index_prefix)
        server.engine.set_index(fm)
        print(f"index loaded from {index_prefix} ({fm.seq_len // 2} bases)")
    print(f"engine daemon listening on {server.address[0]}:{server.address[1]}",
          flush=True)
    try:
        server._server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

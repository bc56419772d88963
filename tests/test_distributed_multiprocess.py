"""Multi-process jax.distributed run on the CPU backend.

The reference tests its distributed (Blaze) path in-process over loopback
TCP (LOCAL_BLAZE, pairhmm/host/main.cpp:253-274).  This engine's
distributed substrate is jax.distributed + shard_map; this test stands in
for LOCAL_BLAZE by launching two real processes that form a jax
coordination service, build a global 2-process mesh, and run the
data-parallel PairHMM forward over globally sharded arrays.
"""

import pytest
import os
import socket
import subprocess
import sys

import numpy as np

pytestmark = pytest.mark.slow  # two-process coordination: minutes of compiles

_WORKER = r"""
import os, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(
    coordinator_address=coord, num_processes=2, process_id=pid,
    local_device_ids=[0],
)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu.ops.pairhmm.jax_impl import forward_from_pack
from acc_genomics_tpu.parallel.sharded import pairhmm_forward_dp

rng = np.random.default_rng(0)  # same data in both processes
tcs = gen_pairhmm_pairs(rng, 16, max_read_len=15, max_hap_len=24)
pack = pack_pairhmm_batch(tcs, rows=16, cols=24, dtype=np.float32, pad_lanes=False)

devs = np.array(jax.devices())  # one device per process -> 2 global
mesh = Mesh(devs.reshape(2), ("data",))

def shard(a, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

args = [shard(np.asarray(v), P(None, "data")) for v in pack.arrays()[:10]]
args.append(shard(np.asarray(pack.arrays()[10]), P("data")))
out = pairhmm_forward_dp(mesh, *args)
# every process sees its local shard; compare against the single-host run
local = np.asarray([s.data for s in out.addressable_shards][0])
want = np.asarray(forward_from_pack(pack))
half = want.reshape(2, -1)[pid]
np.testing.assert_allclose(local, half, rtol=1e-6)
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_jax_distributed(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one device per process, not 8
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out

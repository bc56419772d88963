"""Platform rules: which PairHMM forward each device runs, where the
compile cache lives, the device-trace helpers, and the entry points that
need a GPU refusing to run without one."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from acc_genomics_tpu.ops.pairhmm.kernel import kernel_for_platform
from acc_genomics_tpu.utils import cache
from acc_genomics_tpu.utils.devtrace import _union_ns, compiled_programs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,kernel", [("gpu", "pallas"), ("cpu", "xla")])
def test_kernel_for_platform(platform, kernel):
    assert kernel_for_platform(platform) == kernel


@pytest.mark.parametrize("platform", ["rocm", "neuron", "METAL", ""])
def test_kernel_for_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no PairHMM forward"):
        kernel_for_platform(platform)


def test_engine_default_kernel_follows_device():
    from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine

    eng = PairHMMEngine()
    assert eng.kernel == kernel_for_platform(eng.device.platform)
    with pytest.raises(TypeError):  # the platform rule is the only choice
        PairHMMEngine(kernel="pallas")


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_union_of_intervals():
    assert _union_ns([]) == 0
    assert _union_ns([(0, 10), (5, 15), (20, 25)]) == 20
    assert _union_ns([(3, 4), (0, 10)]) == 10


def test_compiled_programs_records_memory():
    import jax.numpy as jnp

    with compiled_programs() as progs:
        jax.jit(lambda x: x * 3 + 1)(jnp.arange(4096.0)).block_until_ready()
    names = [n for n in progs if "<lambda>" in n]
    assert names
    mem = progs[names[0]].get_compiled_memory_stats()
    assert mem.argument_size_in_bytes >= 4096 * 4


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    r = _run([os.path.join(ROOT, script)], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.gpu
def test_pallas_kernel_compiled_matches_xla(rng):
    """The Triton-compiled kernel against the XLA row scan (card only)."""
    from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu.ops.pairhmm.kernel import forward_from_pack
    from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch

    tcs = gen_pairhmm_pairs(rng, 300, max_read_len=90, max_hap_len=200)
    pack = pack_pairhmm_batch(tcs, rows=96, cols=256, sort_by_haplen=True)
    got = np.asarray(forward_from_pack(pack, "pallas"))
    want = np.asarray(forward_from_pack(pack, "xla"))
    ok = want >= 1e-28
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4)

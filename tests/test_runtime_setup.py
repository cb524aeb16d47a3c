"""Where the program keeps its compile cache and native libraries, which
backend it routes to, the peaks table, and the f32 precision pin."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tulip_tpu as tlp
from tulip_tpu import utils
from tulip_tpu.kkt import make_backend
from tulip_tpu.status import TerminationStatus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Enable the cache, compile one program, print the cache directory.
_CACHE_PROBE = textwrap.dedent("""
    import jax, jax.numpy as jnp
    from tulip_tpu.utils import enable_compile_cache
    path = enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(7)).block_until_ready()
    print(path)
""")


def _cache_probe(env, salt):
    r = subprocess.run([sys.executable, "-c",
                        _CACHE_PROBE.format(salt=salt)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def _files(path):
    return {os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs}


def test_compile_cache_uses_env_dir_only(tmp_path):
    default = os.path.join(ROOT, ".jax_cache")
    before = _files(default)
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_probe(env, salt=3.25) == str(tmp_path)
    assert _files(tmp_path), "nothing cached in JAX_COMPILATION_CACHE_DIR"
    assert _files(default) == before


def test_compile_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    path = _cache_probe(env, salt=4.5)
    assert path == os.path.join(ROOT, ".jax_cache",
                                utils.machine_fingerprint())
    assert _files(path)


def _native_copy(tmp_path):
    """native/ sources and Makefile in a fresh directory, with a build/
    holding placeholder libraries stamped newer than their sources."""
    nat = tmp_path / "native"
    nat.mkdir()
    for f in ("Makefile", "mps_tokenizer.cpp", "presolve.cpp",
              "symbolic.cpp"):
        shutil.copy(os.path.join(ROOT, "native", f), nat / f)
        os.utime(nat / f, (1_000_000, 1_000_000))
    (nat / "build").mkdir()
    for lib in ("libtulip_mps.so", "libtulip_symbolic.so",
                "libtulip_presolve.so"):
        (nat / "build" / lib).write_bytes(b"placeholder")
        os.utime(nat / "build" / lib, (2_000_000, 2_000_000))
    return nat


def test_native_source_newer_than_library_is_rebuilt(tmp_path):
    nat = _native_copy(tmp_path)
    os.utime(nat / "mps_tokenizer.cpp", (3_000_000, 3_000_000))
    assert utils.make_native(str(nat))
    mps = (nat / "build" / "libtulip_mps.so").read_bytes()
    assert mps.startswith(b"\x7fELF")              # rebuilt from source
    assert (nat / "build" / "libtulip_symbolic.so").read_bytes() \
        == b"placeholder"                         # up to date: untouched


def test_native_library_path_when_up_to_date(tmp_path, monkeypatch):
    nat = _native_copy(tmp_path)
    monkeypatch.delenv("TULIP_NATIVE_DIR", raising=False)
    path = utils.native_library("libtulip_presolve.so", str(nat))
    assert path == str(nat / "build" / "libtulip_presolve.so")
    assert (nat / "build" / "libtulip_presolve.so").read_bytes() \
        == b"placeholder"


def test_native_library_none_when_build_fails(tmp_path, monkeypatch):
    nat = _native_copy(tmp_path)
    (nat / "presolve.cpp").write_text("this is not C++\n")
    monkeypatch.delenv("TULIP_NATIVE_DIR", raising=False)
    assert utils.native_library("libtulip_presolve.so", str(nat)) is None


@pytest.mark.parametrize("platform", ["cpu", "gpu", "other"])
def test_f32_route_does_not_depend_on_platform(monkeypatch, platform):
    """Backend choice comes from the problem, not from the device."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    m = tlp.Model()
    tlp.load_problem(m, os.path.join(ROOT, "tests", "data", "lp_opt.mps"))
    m.params.ArithmeticDtype = "float32"
    assert m.optimize() == TerminationStatus.OPTIMAL
    assert m.kkt_backend.name == "dense"
    res = tlp.batch_linprog([dict(c=[1.0, 1.0], A_eq=[[1.0, 1.0]],
                                  b_eq=[1.0])], presolve=False)
    assert res[0].success


@pytest.mark.parametrize("name", ["pallas-small", "dense-pallas"])
def test_make_backend_rejects_removed_names(name):
    with pytest.raises(ValueError, match="unknown KKT backend"):
        make_backend(name)


def _peaks():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import card

    return card


def test_peaks_table_knows_h100():
    p = _peaks().device_peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16"] == 989e12 and p["f64"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Quadro RTX 6000"])
def test_peaks_table_rejects_unknown_kind(kind):
    with pytest.raises(KeyError):
        _peaks().device_peaks(kind)


@pytest.mark.parametrize("algo", ["HSD", "MPC"])
def test_f32_starting_point_pinned_to_highest(monkeypatch, algo):
    """The starting point is computed with "highest" f32 matmuls whether
    the loop runs on the device (OutputLevel 0) or from the host
    (OutputLevel 1), and both give the same point."""
    import jax

    from tulip_tpu.ipm import hsd, mpc

    mod, name = (hsd, "init_state") if algo == "HSD" \
        else (mpc, "init_state_mpc")
    orig = getattr(mod, name)
    seen = []

    def recording(*a, **k):
        seen.append(jax.config.jax_default_matmul_precision)
        return orig(*a, **k)

    monkeypatch.setattr(mod, name, recording)
    starts = []
    for level in (0, 1):
        m = tlp.Model()
        tlp.load_problem(m, os.path.join(ROOT, "tests", "data",
                                         "lp_opt.mps"))
        m.params.ArithmeticDtype = "float32"
        m.params.OutputLevel = level
        m.params.IPM.Algorithm = algo
        m.params.IPM.IterationsLimit = 0
        m.params.Presolve.Level = 0
        m.optimize()
        starts.append(np.asarray(m.solver_state.pt.x))
    assert seen == ["highest", "highest"]
    np.testing.assert_array_equal(starts[0], starts[1])

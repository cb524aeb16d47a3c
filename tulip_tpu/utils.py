"""Small shared helpers (reference: src/utils.jl)."""

from __future__ import annotations

import bz2
import gzip
import io
import os
from typing import Optional

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NATIVE_DIR = os.path.join(REPO_ROOT, "native")


def open_maybe_compressed(fname: str) -> io.TextIOBase:
    """Open a text file, transparently decompressing .gz / .bz2
    (reference: src/utils.jl:9-20)."""
    if fname.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(fname, "rb"))
    if fname.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(fname, "rb"))
    return open(fname, "r")


def pos_part(x: float) -> float:
    return x if x >= 0 else 0.0


def neg_part(x: float) -> float:
    return -x if x < 0 else 0.0


def machine_fingerprint() -> str:
    """Short id of the host CPU's instruction-set profile.

    XLA:CPU AOT cache artifacts bake in the compile host's features;
    loading one on a host with a different profile can SIGILL/segfault.
    The default compile-cache directory is keyed by this."""
    import hashlib
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith(("flags", "Features"))]
        return hashlib.sha1(
            (platform.machine() + (flags[0] if flags else "")).encode()
        ).hexdigest()[:12]
    except OSError:
        return platform.machine() or "unknown"


_exec_budget_used = 0


def bound_live_executables(estimate: int = 1) -> bool:
    """Library-side guard for the XLA:CPU resident-executable crash
    (docs/xla_cpu_executable_crash.md): callers that compile unbounded
    numbers of distinct programs (heterogeneous ``batch_linprog`` shape
    buckets) report each compilation here; once the process-wide budget
    (env ``TULIP_MAX_LIVE_EXECUTABLES``, default 192) is exceeded, jax's
    compiled-program caches are cleared. Re-solving a cleared shape
    recompiles in seconds instead of risking a hard SIGSEGV/SIGABRT in a
    later large compile. Returns True when a clear happened."""
    global _exec_budget_used

    budget = int(os.environ.get("TULIP_MAX_LIVE_EXECUTABLES", "192"))
    _exec_budget_used += estimate
    if _exec_budget_used < budget:
        return False
    import jax

    jax.clear_caches()
    _exec_budget_used = 0
    return True


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets no other directory. Otherwise the cache goes to
    ``<checkout>/.jax_cache/<machine_fingerprint()>``: a fixed path, so a
    later process finds what an earlier one compiled."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache", machine_fingerprint())
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


_native_made: dict = {}


def native_library(name: str, native_dir: str = NATIVE_DIR
                   ) -> Optional[str]:
    """Path of the native library ``name``, up to date with its source.

    The first call in a process runs ``make -C native`` (which does nothing
    when every library is newer than its source), so a library left from
    older sources is rebuilt before it is loaded. Returns None when the
    build fails or the library is missing; callers then use their Python
    paths. ``TULIP_NATIVE_DIR`` selects another build directory under
    ``native/`` (e.g. an AddressSanitizer build); that one is built by
    hand with its own flags and is used as it is."""
    sub = os.environ.get("TULIP_NATIVE_DIR", "build")
    if sub == "build":
        if native_dir not in _native_made:
            _native_made[native_dir] = make_native(native_dir)
        if not _native_made[native_dir]:
            return None
    path = os.path.join(native_dir, sub, name)
    return path if os.path.exists(path) else None


def make_native(native_dir: str = NATIVE_DIR) -> bool:
    """Run ``make -C native_dir`` under a file lock (concurrent processes
    would otherwise race on one output file). True when make succeeded."""
    import fcntl
    import subprocess

    try:
        os.makedirs(os.path.join(native_dir, "build"), exist_ok=True)
        with open(os.path.join(native_dir, "build", ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", native_dir], check=True,
                           capture_output=True, timeout=300)
        return True
    except (OSError, subprocess.SubprocessError):
        return False

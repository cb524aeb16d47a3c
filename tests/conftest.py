"""Test configuration: a virtual 8-device CPU mesh for the sharding tests.

``JAX_PLATFORMS`` defaults to ``cpu``; an explicit value is respected, so
the card-only tests (marker ``gpu``) reach the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0``."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    The full suite accumulates hundreds of resident XLA:CPU executables;
    past ~300 tests that state has produced hard crashes (SIGSEGV/
    SIGABRT) inside later large compiles (observed on the m=2048 tiled-K2
    program, which passes in isolation under identical flags). Bounding
    the live-executable set keeps the process well clear of that regime.
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]

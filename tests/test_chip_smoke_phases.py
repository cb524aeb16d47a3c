"""chip_smoke.py's phases as functions, at tiny sizes on the CPU. The
multi-device phases run on 4 of conftest's 8 virtual CPU devices."""

import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _check_common(out):
    assert out["compile_s"] >= 0.0
    assert out["err"] >= 0.0


def test_phase_cli():
    out = cs.phase_cli(m_stair=256)
    _check_common(out)
    assert out["err"] <= 1e-7


def test_phase_mid():
    out = cs.phase_mid(m=256)
    _check_common(out)
    assert out["backend"] == "dense"


def test_phase_large_runs_sparse_first_whole_solve():
    """The sparse-first data path through the whole-solve while_loop, with
    the compiled program's memory read back."""
    out = cs.phase_large(m=2048, sparse_first=True)
    _check_common(out)
    assert out["backend"] in ("sparse", "sparse-smw")
    assert out["temp_bytes"] is not None and out["argument_bytes"] > 0


def test_phase_batch():
    out = cs.phase_batch(nb=64, n_highs=8)
    _check_common(out)
    assert out["iters_max"] >= out["iters_mean"] > 0


@pytest.fixture
def four_devices():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.fail(f"conftest should give 8 CPU devices, got {len(devs)}")
    return devs[:4]


def test_phase_multi_batch(four_devices):
    out = cs.phase_multi_batch(four_devices, per_device=8, m=8, n=16)
    assert out["lanes"] == 32 and out["err"] <= 1e-5
    assert out["lanes_same_iters"] == 32


def test_phase_multi_schur(four_devices):
    out = cs.phase_multi_schur(four_devices, K=8, dims=(3, 16, 4, 8))
    assert out["largest_collective"] <= 16 * 16
    assert out["err"] <= 1e-7

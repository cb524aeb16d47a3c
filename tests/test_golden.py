"""Golden-suite parity tests: classic LP families at Tulip-default 1e-8
tolerances (f64), both algorithms, presolve on/off, objective parity vs
HiGHS (a stand-in for Netlib)."""

import numpy as np
import pytest

import tulip_tpu as tlp
from tulip_tpu.status import TerminationStatus

from golden_lps import ALL_GOLDEN, PARITY_RTOL, scipy_optimum


@pytest.mark.parametrize("algo", ["HSD", "MPC"])
@pytest.mark.parametrize("gen", ALL_GOLDEN, ids=lambda g: g.__name__)
def test_golden_parity(gen, algo):
    pb = gen()
    z_ref = scipy_optimum(pb)

    m = tlp.Model()
    m.pbdata = pb
    m.params.IPM.Algorithm = algo
    st = m.optimize()
    assert st == TerminationStatus.OPTIMAL, pb.name
    z = tlp.get_attribute(m, "ObjectiveValue")
    # Tulip-parity: optimal objective to 1e-8 (relative) on well-posed
    # families; degenerate family bounded by regularization floor.
    rtol = PARITY_RTOL.get(pb.name, 1e-8)
    assert abs(z - z_ref) <= rtol * max(1.0, abs(z_ref)), (
        f"{pb.name}: {z} vs HiGHS {z_ref}")

    zd = tlp.get_attribute(m, "DualObjectiveValue")
    assert abs(zd - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


@pytest.mark.parametrize("gen", ALL_GOLDEN, ids=lambda g: g.__name__)
def test_golden_presolve_off(gen):
    pb = gen()
    z_ref = scipy_optimum(pb)
    m = tlp.Model()
    m.pbdata = pb
    m.params.Presolve.Level = 0
    st = m.optimize()
    assert st == TerminationStatus.OPTIMAL
    z = tlp.get_attribute(m, "ObjectiveValue")
    # Without presolve there is no equilibration scaling; attainable
    # accuracy at a 1e-8 gap tolerance is a few×1e-8 relative.
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


@pytest.mark.parametrize("backend", ["dense", "dense-ldl", "cg"])
def test_golden_backends(backend):
    pb = ALL_GOLDEN[0]()
    z_ref = scipy_optimum(pb)
    m = tlp.Model()
    m.pbdata = pb
    m.params.KKT.Backend = backend
    st = m.optimize()
    assert st == TerminationStatus.OPTIMAL
    z = tlp.get_attribute(m, "ObjectiveValue")
    tol = 1e-8 if backend != "cg" else 1e-6
    assert abs(z - z_ref) <= tol * max(1.0, abs(z_ref))


@pytest.mark.parametrize(
    "subset", [ALL_GOLDEN[:3],
               pytest.param(ALL_GOLDEN[3:], marks=pytest.mark.slow)],
    ids=["head", "tail"])
def test_golden_mixed_precision_1e8(subset):
    """f32 factorization + f64 refinement reaches 1e-8 objective parity
    (the accelerator answer to f64-only factorizations)."""
    for gen in subset:
        pb = gen()
        z_ref = scipy_optimum(pb)
        m = tlp.Model()
        m.pbdata = pb
        m.params.KKT.Backend = "dense-mixed"
        m.params.IPM.PRegMin = 1e-6
        m.params.IPM.DRegMin = 1e-6
        st = m.optimize()
        assert st == TerminationStatus.OPTIMAL, pb.name
        z = tlp.get_attribute(m, "ObjectiveValue")
        rtol = PARITY_RTOL.get(pb.name, 1e-8)
        assert abs(z - z_ref) <= rtol * max(1.0, abs(z_ref)), (
            f"{pb.name}: {z} vs {z_ref}")

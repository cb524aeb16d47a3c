"""Every non-experimental Krylov backend earns its registry entry through
at least one END-TO-END golden-LP solve at its achievable tolerance
(reference bar: every wired backend runs under MOI
tests, /root/reference/test/Interfaces/MOI_wrapper.jl).

Achievable tolerances are measured facts (see each backend's docstring):
the conformance kit alone did NOT catch two real end-to-end failures —
the cr stopping test measured the preconditioned residual against the
unpreconditioned ‖b‖ (stalled at ITERATION_LIMIT; fixed round 5), and
minares' squared-operator conditioning (now flagged experimental like
TriCG)."""

import warnings

import pytest

import tulip_tpu as tlp
from golden_lps import ALL_GOLDEN, scipy_optimum
from tulip_tpu.status import TerminationStatus

# (backend, IPM tolerance or None for the 1.49e-8 defaults,
#  objective rtol). Raw-K2 methods are tolerance-limited by the unscaled
# late-IPM augmented system (minres ~1e-6, symmlq ~1e-4); everything
# else holds the reference-default sqrt(eps).
KRYLOV_CASES = [
    ("cg", None, 1e-7),
    ("cr", None, 1e-7),
    ("car", None, 1e-7),
    ("minres", 1e-6, 1e-5),
    ("symmlq", 1e-4, 1e-3),
    ("minres-qlp", None, 1e-7),
    ("sqd-minres", None, 1e-7),
    ("lsqr", None, 1e-7),
    ("lsmr", None, 1e-7),
    ("craig", None, 1e-7),
    ("craigmr", None, 1e-7),
]


@pytest.mark.parametrize("backend,tol,rtol",
                         KRYLOV_CASES, ids=[c[0] for c in KRYLOV_CASES])
def test_krylov_backend_end_to_end(backend, tol, rtol):
    pb = ALL_GOLDEN[0]()          # transportation LP
    z_ref = scipy_optimum(pb)
    m = tlp.Model()
    m.pbdata = pb
    m.params.KKT.Backend = backend
    if tol is not None:
        for f in ("TolerancePFeas", "ToleranceDFeas",
                  "ToleranceRGap", "ToleranceIFeas"):
            setattr(m.params.IPM, f, tol)
    st = m.optimize()
    assert st == TerminationStatus.OPTIMAL, backend
    z = tlp.get_attribute(m, "ObjectiveValue")
    assert abs(z - z_ref) <= rtol * max(1.0, abs(z_ref)), (
        f"{backend}: {z} vs {z_ref}")


@pytest.mark.slow
@pytest.mark.parametrize("backend,tol,rtol",
                         KRYLOV_CASES, ids=[c[0] for c in KRYLOV_CASES])
def test_krylov_backend_second_golden(backend, tol, rtol):
    """Second structure (multiperiod chain) for the same battery."""
    pb = ALL_GOLDEN[8]()
    z_ref = scipy_optimum(pb)
    m = tlp.Model()
    m.pbdata = pb
    m.params.KKT.Backend = backend
    if tol is not None:
        for f in ("TolerancePFeas", "ToleranceDFeas",
                  "ToleranceRGap", "ToleranceIFeas"):
            setattr(m.params.IPM, f, tol)
    st = m.optimize()
    assert st == TerminationStatus.OPTIMAL, backend
    z = tlp.get_attribute(m, "ObjectiveValue")
    assert abs(z - z_ref) <= rtol * max(1.0, abs(z_ref))


def test_experimental_backends_warn():
    """tricg and minares are experimental: instantiating through
    make_backend warns, and they are excluded from the end-to-end
    battery by design (kit-only validation)."""
    from tulip_tpu.kkt import available_backends, make_backend

    exp = {n for n, c in available_backends().items() if c.experimental}
    assert exp == {"tricg", "minares"}
    for name in sorted(exp):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            make_backend(name, None, 0)
        assert any("experimental" in str(x.message) for x in w), name


def test_all_registered_backends_covered():
    """The registry and the end-to-end batteries stay in sync: every
    non-experimental backend name appears in some end-to-end test
    battery (this module, test_golden.py, or the large-scale/structured
    suites)."""
    from tulip_tpu.kkt import available_backends

    covered = {c[0] for c in KRYLOV_CASES} | {
        # test_golden.py / conformance batteries
        "dense", "dense-ldl", "dense-mixed",
        "extended", "extended-dd",
        # large-scale structured suites (test_large_scale, test_sparse_*)
        "banded", "sparse", "sparse-smw", "sparse-ldl",
        # sharded (test_block_angular)
        "schur",
    }
    missing = [n for n, c in available_backends().items()
               if not c.experimental and n not in covered]
    assert not missing, f"backends with no end-to-end coverage: {missing}"

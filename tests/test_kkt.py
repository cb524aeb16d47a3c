"""KKT backend conformance tests.

Mirrors the reference's per-backend contract tests
(reference: test/KKT/*): every backend × supported arithmetic goes through
the shared conformance kit on a fixed small matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tulip_tpu.kkt import (CarK1Backend, CgK1Backend, CraigK1Backend,
                           CraigmrK1Backend, CrK1Backend,
                           DenseK1Backend, DenseK2Backend,
                           LsmrK1Backend, LsqrK1Backend,
                           MinaresK2Backend, MinresK2Backend,
                           MinresQlpK2Backend, SparseK2Backend,
                           SplitK1Backend, SqdMinresK2Backend,
                           SymmlqK2Backend, TricgK2Backend, make_backend)
from tulip_tpu.kkt.dense_ldl import ldl_nopivot
from tulip_tpu.kkt.testkit import run_ls_tests

# Fixed 2x4 test matrix (same shape role as reference test/KKT fixtures).
A_np = np.array([
    [1.0, 0.0, 2.0, -1.0],
    [0.0, 1.0, -1.0, 3.0],
])

BACKENDS = [
    DenseK1Backend(),
    DenseK1Backend(refinement_steps=2),
    DenseK1Backend(inv_factor=True, refinement_steps=1),
    DenseK2Backend(),
    CgK1Backend(),
    CrK1Backend(),
    CarK1Backend(),
    LsqrK1Backend(),
    LsmrK1Backend(),
    CraigK1Backend(),
    CraigmrK1Backend(),
    MinresK2Backend(),
    MinresQlpK2Backend(),
    MinaresK2Backend(),
    TricgK2Backend(),
    SqdMinresK2Backend(),
    SymmlqK2Backend(),
    # Structured backends dispatch through their dense fallbacks on this
    # tiny fixture — the dispatch itself is part of the contract.
    SplitK1Backend(block=8, refinement_steps=1),
    SparseK2Backend(block=8, refinement_steps=1),
]


def test_sqd_minres_end_to_end():
    """Full HSD solve through the SQD-scaled MINRES backend reaches 1e-8
    objective parity with HiGHS (the SQD family's end-to-end workhorse;
    TriCG is contract-conformant but loses orthogonality once Θ spans
    ~16 orders of magnitude near convergence — see krylov.py docstring)."""
    from scipy.optimize import linprog

    from tulip_tpu.ipm.data import make_lp_data
    from tulip_tpu.ipm.hsd import HSDOptions, hsd_solve

    rng = np.random.default_rng(3)
    m, n = 30, 60
    A = rng.standard_normal((m, n))
    u = rng.uniform(1, 4, n)
    x0 = u * rng.uniform(0.2, 0.8, n)
    b = A @ x0
    c = rng.standard_normal(n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(np.zeros(n), u)),
                  method="highs")
    dat = make_lp_data(A, b, c, 0.0, np.zeros(n), u)
    out = hsd_solve(dat, SqdMinresK2Backend(refinement_steps=1),
                    HSDOptions())
    assert int(out.status) == 2
    assert abs(float(out.pobj) - ref.fun) < 1e-8 * max(1.0, abs(ref.fun))


def test_tricg_matches_direct_solve():
    """TriCG on a random SQD system with wildly scaled diagonals matches a
    direct solve (the regime where unpreconditioned MINRES struggles)."""
    rng = np.random.default_rng(0)
    m, n = 7, 11
    A = jnp.asarray(rng.standard_normal((m, n)))
    theta_reg = jnp.asarray(10.0 ** rng.uniform(-4, 4, n))
    regD = jnp.asarray(rng.uniform(0.5, 3.0, m))
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))

    b = TricgK2Backend()
    st = b.setup(A)
    st, ok = b.update(st, theta_reg - 1e-8, jnp.full(n, 1e-8), regD)
    assert bool(ok)
    dx, dy = b.solve(st, xi_p, xi_d)

    K = np.block([[-np.diag(np.asarray(theta_reg)), np.asarray(A).T],
                  [np.asarray(A), np.diag(np.asarray(regD))]])
    sol = np.linalg.solve(K, np.concatenate([np.asarray(xi_d),
                                             np.asarray(xi_p)]))
    got = np.concatenate([np.asarray(dx), np.asarray(dy)])
    np.testing.assert_allclose(got, sol, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b.name + (
    f"-r{b.refinement_steps}" if b.refinement_steps else ""))
def test_conformance(backend, dtype):
    A = jnp.asarray(A_np, dtype=dtype)
    run_ls_tests(A, backend)


def test_make_backend_registry():
    assert make_backend().name == "dense"
    assert make_backend(system="K2").name == "dense-ldl"
    assert make_backend("cg").name == "cg"
    with pytest.raises(ValueError):
        make_backend("cg", system="K2")


def test_ldl_nopivot_quasidefinite():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 5))
    K = np.zeros((8, 8))
    K[:5, :5] = -np.eye(5) * 2.0
    K[:5, 5:] = A.T
    K[5:, :5] = A
    K[5:, 5:] = np.eye(3) * 0.5
    L, d, ok = ldl_nopivot(jnp.asarray(K))
    assert bool(ok)
    K_rec = np.asarray(L) @ np.diag(np.asarray(d)) @ np.asarray(L).T
    np.testing.assert_allclose(K_rec, K, atol=1e-10)


def test_update_reports_failure_on_indefinite():
    # regD = -1 makes K1 normal equations indefinite -> Cholesky fails.
    A = jnp.asarray(A_np)
    b = DenseK1Backend()
    st = b.setup(A)
    st, ok = b.update(st, jnp.ones(4), jnp.ones(4) * 1e-12,
                      -jnp.ones(2) * 100.0)
    assert not bool(ok)


def test_refinement_improves_f32():
    rng = np.random.default_rng(1)
    A = jnp.asarray(rng.standard_normal((20, 40)), dtype=jnp.float32)
    theta_inv = jnp.asarray(10.0 ** rng.uniform(-6, 6, 40), jnp.float32)
    regP = jnp.full(40, 1e-6, jnp.float32)
    regD = jnp.full(20, 1e-6, jnp.float32)
    xi_p = jnp.asarray(rng.standard_normal(20), jnp.float32)
    xi_d = jnp.asarray(rng.standard_normal(40), jnp.float32)

    def resid(backend):
        st = backend.setup(A)
        st, ok = backend.update(st, theta_inv, regP, regD)
        assert bool(ok)
        dx, dy = backend.solve(st, xi_p, xi_d)
        rd = xi_d - (-(theta_inv + regP) * dx + A.T @ dy)
        rp = xi_p - (A @ dx + regD * dy)
        return max(float(jnp.max(jnp.abs(rd))), float(jnp.max(jnp.abs(rp))))

    r0 = resid(DenseK1Backend())
    r2 = resid(DenseK1Backend(refinement_steps=2))
    assert r2 <= r0


def test_mixed_precision_conformance():
    from tulip_tpu.kkt import MixedK1Backend

    A = jnp.asarray(A_np, dtype=jnp.float64)
    run_ls_tests(A, MixedK1Backend())


def test_banded_backend():
    """RCM block-tridiagonal backend: staircase LP gets a banded plan and
    matches the dense solve; a dense-pattern matrix falls back."""
    import jax
    from tulip_tpu.kkt import BandedK1Backend
    from tulip_tpu.kkt.banded import BandedK1State, rcm_bandwidth

    rng = np.random.default_rng(0)
    # Staircase structure: 40 stages, 8 rows each, coupling adjacent
    # stages through shared columns.
    stages, mr, nc = 40, 8, 12
    m = stages * mr
    n = stages * nc + nc
    A = np.zeros((m, n))
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+2)*nc] = rng.standard_normal((mr, 2*nc))
    perm, bw = rcm_bandwidth(A)
    assert bw < m // 4  # genuinely banded

    from tulip_tpu.kkt.sparse import SparseK1LevelState

    # Default schedule routes through the shared level engine; the scan
    # path stays available as schedule="scan".
    backend = BandedK1Backend(min_block=32)
    st = backend.setup(jnp.asarray(A))
    assert isinstance(st, (BandedK1State, SparseK1LevelState))
    st_scan = BandedK1Backend(min_block=32, schedule="scan").setup(
        jnp.asarray(A))
    assert isinstance(st_scan, BandedK1State)

    theta_inv = jnp.asarray(10.0 ** rng.uniform(-2, 2, n))
    regP = jnp.full(n, 1e-8)
    regD = jnp.full(m, 1e-8)
    st, ok = backend.update(st, theta_inv, regP, regD)
    assert bool(ok)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))
    dx, dy = backend.solve(st, xi_p, xi_d)
    rd = np.asarray(xi_d) - (-(np.asarray(theta_inv) + 1e-8) * np.asarray(dx)
                             + A.T @ np.asarray(dy))
    rp = np.asarray(xi_p) - (A @ np.asarray(dx) + 1e-8 * np.asarray(dy))
    assert np.max(np.abs(rd)) < 1e-6
    assert np.max(np.abs(rp)) < 1e-6

    # Dense-pattern matrix -> fallback to the dense state.
    Ad = jnp.asarray(rng.standard_normal((10, 20)))
    std = backend.setup(Ad)
    assert not isinstance(std, BandedK1State)
    run_ls_tests(Ad, _BandedWrapper(backend))


class _BandedWrapper:
    """Adapter so run_ls_tests drives the banded backend's full dispatch."""

    def __init__(self, b):
        self._b = b
        self.name = b.name

    def setup(self, A):
        return self._b.setup(A)

    def update(self, st, ti, rp, rd):
        return self._b.update(st, ti, rp, rd)

    def solve(self, st, xp, xd):
        return self._b.solve(st, xp, xd)


def test_banded_end_to_end_staircase():
    """Full HSD solve through the banded backend vs scipy on a staircase
    LP."""
    from scipy.optimize import linprog

    from tulip_tpu.ipm.data import make_lp_data
    from tulip_tpu.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu.kkt import BandedK1Backend

    rng = np.random.default_rng(1)
    stages, mr, nc = 12, 4, 7
    m = stages * mr
    n = stages * nc + nc
    A = np.zeros((m, n))
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+2)*nc] = rng.standard_normal((mr, 2*nc))
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    b = A @ x0
    c = rng.standard_normal(n)
    dat = make_lp_data(A, b, c, 0.0, np.zeros(n), u)
    out = hsd_solve(dat, BandedK1Backend(min_block=8, refinement_steps=1),
                    HSDOptions())
    assert int(out.status) == 2
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(np.zeros(n), u)),
                method="highs")
    assert r.status == 0
    assert abs(float(out.pobj) - r.fun) < 1e-7 * max(1, abs(r.fun))


def test_sparse_tiled_backend():
    """Tile-granular sparse Cholesky: cyclic staircase (corner tile forces
    cascading symbolic fill) matches the augmented-system contract; a
    dense-column pattern falls back to the dense state."""
    import jax
    from tulip_tpu.kkt import SparseK1Backend
    from tulip_tpu.kkt.sparse import SparseK1State

    rng = np.random.default_rng(1)
    stages, mr, nc = 16, 16, 20
    m, n = stages * mr, stages * nc
    A = np.zeros((m, n))
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+1)*nc] = rng.standard_normal((mr, nc))
        t = (s + 1) % stages
        A[s*mr:(s+1)*mr, t*nc:(t+1)*nc] = rng.standard_normal((mr, nc))

    from tulip_tpu.kkt.sparse import SparseK1LevelState

    be = SparseK1Backend(block=16, refinement_steps=1)
    st = be.setup(jnp.asarray(A))
    assert isinstance(st, SparseK1LevelState)      # default: level schedule
    be_col = SparseK1Backend(block=16, refinement_steps=1,
                             schedule="column")
    assert isinstance(be_col.setup(jnp.asarray(A)), SparseK1State)
    theta_inv = jnp.asarray(10.0 ** rng.uniform(-3, 3, n))
    st, ok = be.update(st, theta_inv, jnp.full(n, 1e-8), jnp.full(m, 1e-8))
    assert bool(ok)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))
    dx, dy = be.solve(st, xi_p, xi_d)
    rd = np.asarray(xi_d) - (-(np.asarray(theta_inv) + 1e-8) * np.asarray(dx)
                             + A.T @ np.asarray(dy))
    rp = np.asarray(xi_p) - (A @ np.asarray(dx) + 1e-8 * np.asarray(dy))
    assert np.max(np.abs(rd)) < 1e-7
    assert np.max(np.abs(rp)) < 1e-7

    # A block-dense coupling column makes K = A Aᵀ dense -> fallback.
    A2 = np.zeros((64, 100))
    A2[:, :10] = rng.standard_normal((64, 10))
    for k in range(4):
        A2[k*16:(k+1)*16, 10+k*20:10+(k+1)*20] = rng.standard_normal((16, 20))
    assert not isinstance(be.setup(jnp.asarray(A2)),
                          (SparseK1State, SparseK1LevelState))


def test_sparse_end_to_end_staircase():
    """Full HSD solve through the tiled sparse backend vs HiGHS."""
    from scipy.optimize import linprog

    from tulip_tpu.ipm.data import make_lp_data
    from tulip_tpu.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu.kkt import SparseK1Backend

    rng = np.random.default_rng(5)
    stages, mr, nc = 10, 6, 9
    m = stages * mr
    n = stages * nc + nc
    A = np.zeros((m, n))
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+2)*nc] = rng.standard_normal((mr, 2*nc))
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    b = A @ x0
    c = rng.standard_normal(n)
    dat = make_lp_data(A, b, c, 0.0, np.zeros(n), u)
    out = hsd_solve(dat, SparseK1Backend(block=8, refinement_steps=1),
                    HSDOptions())
    assert int(out.status) == 2
    r = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(np.zeros(n), u)),
                method="highs")
    assert r.status == 0
    assert abs(float(out.pobj) - r.fun) < 1e-7 * max(1, abs(r.fun))


def test_rcm_pattern_no_int8_overflow():
    """A dense matrix with >=256 shared columns must not be classified as
    banded (int8 pattern-count overflow wrapped 512 to 0)."""
    from tulip_tpu.kkt.banded import rcm_bandwidth

    rng = np.random.default_rng(0)
    A = rng.standard_normal((300, 512))
    _, bw = rcm_bandwidth(A)
    assert bw == 299


def test_symmlq_matches_direct_solve():
    """SYMMLQ on a random symmetric INDEFINITE system matches a direct
    solve (the regime Galerkin-on-tridiagonal must handle without
    breakdown)."""
    from tulip_tpu.kkt.krylov import symmlq

    rng = np.random.default_rng(2)
    n = 40
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    eigs = rng.uniform(0.5, 5.0, n)
    eigs[: n // 3] *= -1.0
    A = jnp.asarray(Q @ np.diag(eigs) @ Q.T)
    b = jnp.asarray(rng.standard_normal(n))
    x = symmlq(lambda v: A @ v, b, 1e-12, 400)
    xd = np.linalg.solve(np.asarray(A), np.asarray(b))
    np.testing.assert_allclose(np.asarray(x), xd, rtol=1e-8, atol=1e-9)


def test_minres_qlp_minimum_length_on_singular():
    """MINRES-QLP's distinguishing property vs plain MINRES: on a singular
    consistent symmetric system it converges to the minimum-length
    solution (Choi, Paige & Saunders 2011)."""
    from tulip_tpu.kkt.krylov import minres_qlp

    rng = np.random.default_rng(7)
    n, r = 30, 18
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    d = np.concatenate([rng.uniform(0.5, 5.0, r) * rng.choice([-1, 1], r),
                        np.zeros(n - r)])
    A = Q @ np.diag(d) @ Q.T
    b = A @ rng.standard_normal(n)          # consistent RHS
    x_min = np.linalg.lstsq(A, b, rcond=None)[0]
    x = minres_qlp(lambda w: jnp.asarray(A) @ w, jnp.asarray(b), 1e-12, 400)
    np.testing.assert_allclose(np.asarray(x), x_min, rtol=1e-8, atol=1e-10)


def test_minres_qlp_matches_direct_solve_indefinite():
    from tulip_tpu.kkt.krylov import minres_qlp

    rng = np.random.default_rng(11)
    n = 40
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    d = rng.uniform(0.5, 5.0, n) * rng.choice([-1, 1], n)
    A = Q @ np.diag(d) @ Q.T
    b = rng.standard_normal(n)
    x = minres_qlp(lambda w: jnp.asarray(A) @ w, jnp.asarray(b), 1e-12, 400)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               rtol=1e-9, atol=1e-12)


def test_car_matches_direct_solve_spd():
    from tulip_tpu.kkt.krylov import car

    rng = np.random.default_rng(5)
    n = 35
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x = car(lambda w: jnp.asarray(A) @ w, jnp.asarray(b), None, 1e-12, 400)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b),
                               rtol=1e-9, atol=1e-12)


def test_car_monotone_A_norm_residual():
    """CAR's defining optimality: ||r_k||_A decreases monotonically."""
    import jax

    from tulip_tpu.kkt.krylov import car

    rng = np.random.default_rng(9)
    n = 25
    M = rng.standard_normal((n, n))
    A = M @ M.T + 0.5 * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    norms = []
    for k in range(1, 12):
        x = np.asarray(car(lambda w: Aj @ w, jnp.asarray(b), None, 0.0, k))
        r = b - A @ x
        norms.append(float(r @ A @ r))
    assert all(b2 <= a2 * (1 + 1e-10) for a2, b2 in zip(norms, norms[1:]))


def test_lsqr_lsmr_match_lstsq():
    """Golub-Kahan LS solvers match numpy's lstsq on tall systems."""
    from tulip_tpu.kkt.krylov import lsmr, lsqr

    rng = np.random.default_rng(13)
    mm, nn = 40, 15
    A = rng.standard_normal((mm, nn))
    b = rng.standard_normal(mm)
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    Aj = jnp.asarray(A)
    for fn in (lsqr, lsmr):
        x = fn(lambda v: Aj @ v, lambda u: Aj.T @ u, jnp.asarray(b), nn,
               1e-13, 2000)
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-10,
                                   atol=1e-12)


def test_lsqr_backend_never_forms_normal_matrix():
    """The damped-LS backends solve the K1 system to the same answer as the
    dense direct backend on an ill-conditioned Theta (the regime the LS
    formulation is built for: kappa(Abar) = sqrt(kappa(K1)))."""
    rng = np.random.default_rng(17)
    m, n = 10, 25
    A = jnp.asarray(rng.standard_normal((m, n)))
    theta_inv = jnp.asarray(10.0 ** rng.uniform(-6, 6, n))
    regP = jnp.full(n, 1e-8)
    regD = jnp.full(m, 1e-8)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))

    ref = DenseK1Backend(refinement_steps=2)
    st = ref.setup(A)
    st, _ = ref.update(st, theta_inv, regP, regD)
    dx_ref, dy_ref = ref.solve(st, xi_p, xi_d)

    for backend in (LsqrK1Backend(refinement_steps=1),
                    LsmrK1Backend(refinement_steps=1)):
        st = backend.setup(A)
        st, ok = backend.update(st, theta_inv, regP, regD)
        assert bool(ok)
        dx, dy = backend.solve(st, xi_p, xi_d)
        np.testing.assert_allclose(np.asarray(dy), np.asarray(dy_ref),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(dx), np.asarray(dx_ref),
                                   rtol=1e-6, atol=1e-8)


def test_craig_min_norm_matches_pinv():
    """CRAIG returns the minimum-norm solution of a consistent
    underdetermined system (= pinv solution)."""
    from tulip_tpu.kkt.krylov import craig

    rng = np.random.default_rng(23)
    mm, nn = 12, 30
    A = rng.standard_normal((mm, nn))
    b = rng.standard_normal(mm)
    w_ref = np.linalg.pinv(A) @ b
    Aj = jnp.asarray(A)
    w = craig(lambda v: Aj @ v, lambda u: Aj.T @ u, jnp.asarray(b), nn,
              1e-13, 2000)
    np.testing.assert_allclose(np.asarray(w), w_ref, rtol=1e-9, atol=1e-11)


def test_craig_backends_match_direct_solve():
    """The least-norm (LN family) backends solve K1 to the same answer as
    the dense direct backend, without ever forming A E^-1 A^T."""
    rng = np.random.default_rng(29)
    m, n = 10, 25
    A = jnp.asarray(rng.standard_normal((m, n)))
    theta_inv = jnp.asarray(10.0 ** rng.uniform(-4, 4, n))
    regP = jnp.full(n, 1e-8)
    regD = jnp.full(m, 1e-6)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))

    ref = DenseK1Backend(refinement_steps=2)
    st = ref.setup(A)
    st, _ = ref.update(st, theta_inv, regP, regD)
    dx_ref, dy_ref = ref.solve(st, xi_p, xi_d)

    for backend in (CraigK1Backend(refinement_steps=1),
                    CraigmrK1Backend(refinement_steps=1)):
        st = backend.setup(A)
        st, ok = backend.update(st, theta_inv, regP, regD)
        assert bool(ok)
        dx, dy = backend.solve(st, xi_p, xi_d)
        np.testing.assert_allclose(np.asarray(dy), np.asarray(dy_ref),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(dx), np.asarray(dx_ref),
                                   rtol=1e-6, atol=1e-8)


def test_blocked_cholesky_invfactor_matches_xla():
    """Recursive blocked Cholesky+inverse (ops/blocked.py) agrees with
    XLA's cholesky + TRSM, including on non-power-of-two sizes, and
    propagates NaN on non-SPD input."""
    import jax
    import jax.scipy.linalg as jsl

    from tulip_tpu.ops.blocked import cholesky_invfactor_blocked

    rng = np.random.default_rng(11)
    for m in (96, 130, 257):
        G = rng.standard_normal((m, m))
        K = jnp.asarray(G @ G.T + m * np.eye(m))
        L, X = cholesky_invfactor_blocked(K, leaf=64)
        Lref = jnp.linalg.cholesky(K)
        Xref = jsl.solve_triangular(Lref, jnp.eye(m, dtype=K.dtype),
                                    lower=True)
        np.testing.assert_allclose(np.asarray(L), np.asarray(Lref),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(X), np.asarray(Xref),
                                   rtol=5e-8, atol=5e-8)
    # Non-SPD -> NaNs so the reg-bump ladder can detect failure.
    Kbad = jnp.asarray(-np.eye(96))
    L, X = cholesky_invfactor_blocked(Kbad, leaf=64)
    assert not bool(jnp.all(jnp.isfinite(X)))


def test_dense_backend_blocked_path_matches_default():
    """DenseK1Backend with the blocked inv-factor path engaged gives the
    same solves as the XLA path (blocked_min lowered to force it)."""
    rng = np.random.default_rng(12)
    m, n = 96, 150
    A = jnp.asarray(rng.standard_normal((m, n)))
    th = jnp.asarray(10.0 ** rng.uniform(-3, 3, n))
    regP = jnp.full(n, 1e-8)
    regD = jnp.full(m, 1e-8)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))

    from tulip_tpu.kkt import DenseK1Backend

    def run(be):
        st = be.setup(A)
        st, ok = be.update(st, th, regP, regD)
        assert bool(ok)
        return be.solve(st, xi_p, xi_d)

    dx1, dy1 = run(DenseK1Backend(inv_factor=True, blocked_min=64,
                                  refinement_steps=1))
    dx2, dy2 = run(DenseK1Backend(inv_factor=True, refinement_steps=1))
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dy1), np.asarray(dy2),
                               rtol=1e-8, atol=1e-9)


def test_mixed_backend_blocked_path_matches_default():
    """dense-mixed with the blocked f32 chol+inverse engaged solves to
    the same f64-refined accuracy as its XLA path."""
    rng = np.random.default_rng(13)
    m, n = 96, 150
    A = jnp.asarray(rng.standard_normal((m, n)))
    th = jnp.asarray(10.0 ** rng.uniform(-3, 3, n))
    regP = jnp.full(n, 1e-8)
    regD = jnp.full(m, 1e-8)
    xi_p = jnp.asarray(rng.standard_normal(m))
    xi_d = jnp.asarray(rng.standard_normal(n))

    from tulip_tpu.kkt import MixedK1Backend

    def run(be):
        st = be.setup(A)
        st, ok = be.update(st, th, regP, regD)
        assert bool(ok)
        dx, dy = be.solve(st, xi_p, xi_d)
        rd = np.asarray(xi_d) - (-(np.asarray(th) + 1e-8) * np.asarray(dx)
                                 + np.asarray(A).T @ np.asarray(dy))
        assert np.max(np.abs(rd)) < 1e-9
        return dx, dy

    dx1, dy1 = run(MixedK1Backend(blocked_min=64))
    dx2, dy2 = run(MixedK1Backend())
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx2),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.slow
def test_kit_sweep_catches_nd_k2_regression():
    """The hardened kit's ill-conditioning sweep distinguishes the K2
    schedules where the benign kit could not: at
    m=2048 the level (ND) schedule's signed factorization fails at the
    √eps regularization floors on the 16-decade θ sweep — the measured
    reason sparse-ldl defaults to the RCM column schedule — while the column schedule passes with ~1e-15 residuals."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from golden_large import staircase_lp

    from tulip_tpu.kkt.sparse_ldl import SparseK2Backend

    A, b, c, u = staircase_lp(2048)
    A_np = np.asarray(A.todense())

    # Column schedule: passes the full kit including strict sweeps.
    run_ls_tests(A_np, SparseK2Backend(schedule="column",
                                       refinement_steps=2),
                 strict_sweep=True)

    # Level (ND) schedule: the strict sweep catches the regression.
    with pytest.raises(AssertionError, match="sweep"):
        run_ls_tests(A_np, SparseK2Backend(schedule="level",
                                           refinement_steps=2),
                     strict_sweep=True)

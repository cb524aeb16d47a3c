"""The f64 factorization boundary and the dd-factorization fallback
(the reference's BigFloat factorization role,
src/KKT/LDLFactorizations/ldlfact.jl:102-113, test/runtests.jl:9).

Construction: A = the EXACT rational Cholesky factor of the Hilbert
matrix H_n (computed with fractions, rounded to f64). K1 = A·Aᵀ is then
the Hilbert matrix up to f64 rounding; for n = 16, cond(H) ≈ 1e22, so
the f64-assembled Gram matrix is numerically INDEFINITE and the f64
Cholesky fails, while in exact arithmetic K is PD with λmin ≫ eps_dd.
The dd backend assembles and factors in double-word arithmetic and must
both succeed and deliver small FORWARD error (residual-based checks
cannot see this boundary — backward error is small for any factor)."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def hilbert_ldl_f64(n):
    """Exact rational LDLᵀ of H_n; returns A = L·sqrt(D) in f64 (the
    sqrt is applied numerically at the end — the rounding this introduces
    is ~eps_f64·‖A‖, far below the eps_dd assembly accuracy and exactly
    the rounding any f64 input data carries)."""
    H = [[Fraction(1, i + j + 1) for j in range(n)] for i in range(n)]
    L = [[Fraction(0)] * n for _ in range(n)]
    D = [Fraction(0)] * n
    for j in range(n):
        D[j] = H[j][j] - sum(L[j][k] ** 2 * D[k] for k in range(j))
        L[j][j] = Fraction(1)
        for i in range(j + 1, n):
            L[i][j] = (H[i][j]
                       - sum(L[i][k] * L[j][k] * D[k] for k in range(j))
                       ) / D[j]
    Lf = np.array([[float(L[i][j]) for j in range(n)] for i in range(n)])
    Df = np.array([float(d) for d in D])
    assert np.all(Df > 0)
    return Lf * np.sqrt(Df)[None, :]


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield


def test_f64_factorization_fails_cleanly_past_boundary():
    """n=16 Hilbert Gram: the f64 dense backend's factorization FAILS
    (ok=False) — no NaN escapes, the failure is a clean flag the IPM's
    regularization ladder consumes (reference taxonomy:
    PosDefException → Trm_NumericalProblem, src/IPM/HSD/HSD.jl:319-326)."""
    from tulip_tpu.kkt import DenseK1Backend

    A = jnp.asarray(hilbert_ldl_f64(16))
    n = A.shape[1]
    be = DenseK1Backend(refinement_steps=0)
    st = be.setup(A)
    st, ok = be.update(st, jnp.ones(n), jnp.full(n, 1e-30),
                       jnp.full(16, 1e-30))
    assert not bool(ok)
    # The contract after failure: state is factor-safe (identity-patched),
    # solves return finite garbage rather than NaN.
    dx, dy = be.solve(st, jnp.ones(16), jnp.zeros(n))
    assert np.all(np.isfinite(np.asarray(dx)))
    assert np.all(np.isfinite(np.asarray(dy)))


def test_dd_factorization_succeeds_past_boundary():
    """The extended-dd backend assembles + factors the same K in
    double-word arithmetic: update succeeds and the solve has small
    FORWARD error against the exactly-known solution."""
    from tulip_tpu.kkt.extended import ExtendedDDK1Backend

    n_h = 14       # cond(H_14) ≈ 1e18: past f64, comfortable for dd
    A = jnp.asarray(hilbert_ldl_f64(n_h))
    m, n = A.shape
    be = ExtendedDDK1Backend()
    st = be.setup(A)
    st, ok = be.update(st, jnp.ones(n), jnp.zeros(n), jnp.zeros(m))
    assert bool(ok)

    # Ground truth: the EXACT rational solution of the f64 system
    # (A Aᵀ) y = ξp — the f64 rounding of A itself already perturbs the
    # solution by cond·eps relative to the Hilbert ideal, so the oracle
    # must solve the rounded system, not H.
    An = np.asarray(A)
    Kx = [[sum(Fraction(float(An[i, k])) * Fraction(float(An[j, k]))
               for k in range(n)) for j in range(m)] for i in range(m)]
    xi_np = np.ones(m)
    rhs = [Fraction(1) for _ in range(m)]
    # rational Gaussian elimination with partial pivoting
    M = [row[:] + [rhs[i]] for i, row in enumerate(Kx)]
    for col in range(m):
        piv = max(range(col, m), key=lambda r: abs(M[r][col]))
        M[col], M[piv] = M[piv], M[col]
        for r in range(col + 1, m):
            f = M[r][col] / M[col][col]
            for cc in range(col, m + 1):
                M[r][cc] -= f * M[col][cc]
    y_true = [Fraction(0)] * m
    for r in range(m - 1, -1, -1):
        acc = M[r][m] - sum(M[r][cc] * y_true[cc] for cc in range(r + 1, m))
        y_true[r] = acc / M[r][r]
    y_true = np.array([float(v) for v in y_true])

    xi_p = jnp.asarray(xi_np)
    dx, dy = be.solve(st, xi_p, jnp.zeros(n))
    scale = max(1.0, float(np.max(np.abs(y_true))))
    err = float(np.max(np.abs(np.asarray(dy) - y_true))) / scale
    assert err < 1e-9, err

    # Comparison point: the f64 dense path's forward error on the same
    # system is catastrophic (cond·eps ≫ 1) even when its factorization
    # happens to survive at n = 14.
    from tulip_tpu.kkt import DenseK1Backend

    bef = DenseK1Backend(refinement_steps=2)
    stf = bef.setup(A)
    stf, okf = bef.update(stf, jnp.ones(n), jnp.zeros(n), jnp.zeros(m))
    if bool(okf):
        _, dyf = bef.solve(stf, xi_p, jnp.zeros(n))
        err_f64 = float(np.max(np.abs(np.asarray(dyf) - y_true))) / scale
        assert err < err_f64 * 1e-2   # dd is orders of magnitude better


def test_dd_cholesky_reconstructs():
    """dd Cholesky of a moderately conditioned SPD matrix reproduces it
    to ~eps_dd-grade accuracy (sanity on the kernel itself)."""
    from tulip_tpu.kkt.extended import dd_cholesky
    from tulip_tpu.ops import doubledouble as dd

    rng = np.random.default_rng(0)
    n = 24
    B = rng.standard_normal((n, n))
    K = B @ B.T + 10 * np.eye(n)
    Lh, Ll = dd_cholesky(jnp.asarray(K), jnp.zeros((n, n)))
    prod = dd.mul((Lh[:, None, :], Ll[:, None, :]),
                  (Lh[None, :, :], Ll[None, :, :]))
    Krec = dd.sum_(prod, axis=2)
    err = np.max(np.abs(np.asarray(Krec[0]) + np.asarray(Krec[1]) - K))
    assert err < 1e-13 * np.max(np.abs(K))

"""IPM unit tests: residual formulas, step lengths, starting point.

Mirrors the reference's IPM unit tests (reference: test/IPM/HSD.jl:8-149,
test/IPM/MPC.jl): residuals checked against hand-computed values on a tiny
LP; max_step_length edge cases; convergence-flag logic by planting an
optimal point.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tulip_tpu  # noqa: F401  (enables x64)
from tulip_tpu.ipm.data import make_lp_data
from tulip_tpu.ipm.hsd import (HSDOptions, _data_norms, max_step_length,
                               update_status)
from tulip_tpu.ipm import hsd as hsd_mod
from tulip_tpu.ipm.point import (Point, compute_residuals, starting_point,
                                 update_mu)
from tulip_tpu.status import TerminationStatus


# Arithmetic parametrization (reference loops every IPM testset over
# TvTYPES = [Float32, Float64, BigFloat], test/runtests.jl:9; the f32/f64
# pair is the device ladder, extended precision is covered in
# tests/test_doubledouble.py).
DTYPES = [jnp.float32, jnp.float64]


def tol(dt) -> float:
    return 1e-5 if jnp.dtype(dt) == jnp.float32 else 1e-14


def tiny_lp(dtype=jnp.float64):
    """min x1 + 2 x2, s.t. x1 + x2 = 1, x1 - x2 = 0, 0 <= x <= 1."""
    A = [[1.0, 1.0], [1.0, -1.0]]
    return make_lp_data(A, b=[1.0, 0.0], c=[1.0, 2.0], c0=0.0,
                        l=[0.0, 0.0], u=[1.0, 1.0], dtype=dtype)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_residuals_tiny_lp(dt):
    dat = tiny_lp(dt)
    pt = Point(
        x=jnp.array([0.5, 0.5], dt), xl=jnp.array([0.5, 0.5], dt),
        xu=jnp.array([0.5, 0.5], dt), y=jnp.array([1.5, -0.5], dt),
        zl=jnp.array([0.0, 0.0], dt), zu=jnp.array([0.0, 0.0], dt),
        tau=jnp.asarray(1.0, dt), kappa=jnp.asarray(0.0, dt),
        mu=jnp.asarray(0.0, dt))
    res = compute_residuals(dat, pt)
    # At the optimum with tau=1, kappa=0 everything vanishes:
    # rp = b - Ax = 0; rl = l - (x - xl) = 0; ru = u - (x + xu) = 0;
    # rd = c - A'y - zl + zu = 0; rg = c'x - b'y + kappa = 1.5 - 1.5 = 0.
    np.testing.assert_allclose(np.asarray(res.rp), 0.0, atol=tol(dt))
    np.testing.assert_allclose(np.asarray(res.rl), 0.0, atol=tol(dt))
    np.testing.assert_allclose(np.asarray(res.ru), 0.0, atol=tol(dt))
    np.testing.assert_allclose(np.asarray(res.rd), 0.0, atol=tol(dt))
    assert abs(float(res.rg)) < tol(dt)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_residuals_scaled_by_tau(dt):
    dat = tiny_lp(dt)
    pt = starting_point(dat)
    pt = pt._replace(tau=jnp.asarray(2.0, dt))
    res = compute_residuals(dat, pt)
    assert res.rp.dtype == jnp.dtype(dt)
    # rp = tau*b - A x with x = 0 -> 2*b.
    np.testing.assert_allclose(np.asarray(res.rp), [2.0, 0.0], atol=tol(dt))
    # rl = -x + xl + tau*l = xl (l = 0) -> 1.
    np.testing.assert_allclose(np.asarray(res.rl), [1.0, 1.0], atol=tol(dt))
    # ru = -x - xu + tau*u = -1 + 2 = 1.
    np.testing.assert_allclose(np.asarray(res.ru), [1.0, 1.0], atol=tol(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_max_step_length_cases(dt):
    """Edge cases (reference: test/IPM/HSD.jl max_step_length tests)."""
    dat = make_lp_data(np.zeros((1, 2)), [0.0], [0.0, 0.0], 0.0,
                       l=[0.0, 0.0], u=[np.inf, np.inf], dtype=dt)

    def mk(x, dx):
        z = jnp.zeros(2, dt)
        return (Point(x=z, xl=jnp.asarray(x, dt), xu=z, y=jnp.zeros(1, dt),
                      zl=jnp.ones(2, dt), zu=z, tau=jnp.asarray(1.0, dt),
                      kappa=jnp.asarray(1.0, dt), mu=jnp.asarray(1.0, dt)),
                Point(x=z, xl=jnp.asarray(dx, dt), xu=z, y=jnp.zeros(1, dt),
                      zl=jnp.zeros(2, dt), zu=z, tau=jnp.asarray(0.0, dt),
                      kappa=jnp.asarray(0.0, dt), mu=jnp.asarray(0.0, dt)))

    # No negative direction -> step 1.
    pt, d = mk([1.0, 1.0], [1.0, 0.0])
    assert float(max_step_length(dat, pt, d)) == 1.0
    # Blocking coordinate: x=1, dx=-2 -> alpha = 0.5.
    pt, d = mk([1.0, 1.0], [-2.0, 0.0])
    assert abs(float(max_step_length(dat, pt, d)) - 0.5) < tol(dt)
    # tau blocking: dtau < 0.
    pt, d = mk([1.0, 1.0], [0.0, 0.0])
    d = d._replace(tau=jnp.asarray(-4.0, dt))
    assert abs(float(max_step_length(dat, pt, d)) - 0.25) < tol(dt)
    # kappa blocking.
    pt, d = mk([1.0, 1.0], [0.0, 0.0])
    d = d._replace(kappa=jnp.asarray(-2.0, dt))
    assert abs(float(max_step_length(dat, pt, d)) - 0.5) < tol(dt)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_update_status_plants_optimal(dt):
    """Planting a (scaled) optimal point must flag Trm_Optimal
    (reference: test/IPM/HSD.jl convergence tests)."""
    dat = tiny_lp(dt)
    t = 2.0
    pt = Point(
        x=jnp.array([0.5, 0.5], dt) * t, xl=jnp.array([0.5, 0.5], dt) * t,
        xu=jnp.array([0.5, 0.5], dt) * t, y=jnp.array([1.5, -0.5], dt) * t,
        zl=jnp.array([0.0, 0.0], dt), zu=jnp.array([0.0, 0.0], dt),
        tau=jnp.asarray(t, dt), kappa=jnp.asarray(0.0, dt),
        mu=jnp.asarray(0.0, dt))
    pt = update_mu(pt, dat)
    res = compute_residuals(dat, pt)
    # Tolerances at sqrt(eps(T)) like the reference defaults
    # (reference: src/IPM/options.jl:10-13).
    se = float(np.sqrt(np.finfo(np.dtype(jnp.dtype(dt).name)).eps))
    opts = HSDOptions(TolerancePFeas=se, ToleranceDFeas=se,
                      ToleranceRGap=se, ToleranceIFeas=se)
    state = hsd_mod.init_state(dat, __import__(
        "tulip_tpu.kkt", fromlist=["make_backend"]).make_backend())
    state = state._replace(pt=pt, res=res)
    state = update_status(dat, opts, _data_norms(dat), state)
    assert int(state.status) == int(TerminationStatus.OPTIMAL)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_starting_point_masks(dt):
    dat = make_lp_data(np.ones((1, 3)), [1.0], [1.0, 1.0, 1.0], 0.0,
                       l=[0.0, -np.inf, 0.0], u=[np.inf, np.inf, 2.0],
                       dtype=dt)
    pt = starting_point(dat)
    assert pt.xl.dtype == jnp.dtype(dt)
    np.testing.assert_allclose(np.asarray(pt.xl), [1.0, 0.0, 1.0])
    np.testing.assert_allclose(np.asarray(pt.xu), [0.0, 0.0, 1.0])
    np.testing.assert_allclose(np.asarray(pt.zl), [1.0, 0.0, 1.0])
    np.testing.assert_allclose(np.asarray(pt.zu), [0.0, 0.0, 1.0])
    # mu = (xl'zl + xu'zu + tau*kappa)/(p+1) = (2 + 1 + 1)/4 = 1.
    assert abs(float(pt.mu) - 1.0) < tol(dt)


def test_newton_system_residuals():
    """solve_newton_system must satisfy the full 8-block HSD Newton system
    (the reference keeps this as a commented-out debug check,
    reference: src/IPM/HSD/step.jl:254-263)."""
    from functools import partial

    from tulip_tpu.ipm.hsd import NewtonAux, solve_newton_system
    from tulip_tpu.kkt import DenseK1Backend

    rng = np.random.default_rng(0)
    m_, n_ = 5, 9
    A = rng.standard_normal((m_, n_))
    l = np.where(rng.random(n_) < 0.7, rng.uniform(-1, 0, n_), -np.inf)
    u = np.where(rng.random(n_) < 0.7, rng.uniform(1, 2, n_), np.inf)
    # Ensure at least one finite bound overall.
    l[0] = 0.0
    dat = make_lp_data(A, rng.standard_normal(m_), rng.standard_normal(n_),
                       0.0, l, u)
    lf = np.asarray(dat.lflag)
    uf = np.asarray(dat.uflag)

    pt = Point(
        x=jnp.asarray(rng.uniform(0.5, 1.5, n_)),
        xl=jnp.asarray(rng.uniform(0.5, 1.5, n_) * lf),
        xu=jnp.asarray(rng.uniform(0.5, 1.5, n_) * uf),
        y=jnp.asarray(rng.standard_normal(m_)),
        zl=jnp.asarray(rng.uniform(0.5, 1.5, n_) * lf),
        zu=jnp.asarray(rng.uniform(0.5, 1.5, n_) * uf),
        tau=jnp.asarray(1.3), kappa=jnp.asarray(0.7), mu=jnp.asarray(1.0))

    # Build the factorization and the tau-recovery auxiliaries exactly as
    # compute_step does.
    xl_s = np.where(lf > 0, np.asarray(pt.xl), 1.0)
    xu_s = np.where(uf > 0, np.asarray(pt.xu), 1.0)
    theta_l = np.asarray(pt.zl) / xl_s * lf
    theta_u = np.asarray(pt.zu) / xu_s * uf
    theta_inv = jnp.asarray(theta_l + theta_u)
    regP = jnp.full(n_, 1e-10)
    regD = jnp.full(m_, 1e-10)
    regG = 1e-10

    # Free variables (theta_inv = 0) with tiny regP make cond(K) ~ 1/regP
    # on the K1 normal equations; two refinement sweeps restore full-f64
    # augmented-system residuals for this unit check. (In the IPM itself,
    # inexact directions are self-corrected by the outer residual loop.)
    backend = DenseK1Backend(refinement_steps=2)
    kkt = backend.setup(dat.A)
    kkt, ok = backend.update(kkt, theta_inv, regP, regD)
    assert bool(ok)
    kkt_solve = partial(backend.solve, kkt)

    ll = np.asarray(dat.l) * lf
    uu = np.asarray(dat.u) * uf
    cpx = jnp.asarray(np.asarray(dat.c) + theta_l * ll + theta_u * uu)
    xi_ = dat.c - jnp.asarray(theta_l * ll) - jnp.asarray(theta_u * uu)
    hx, hy = kkt_solve(dat.b, xi_)
    h0 = (np.dot(ll, ll * theta_l) + np.dot(uu, uu * theta_u)
          - float(jnp.dot(cpx, hx)) + float(jnp.dot(dat.b, hy))
          + float(pt.kappa / pt.tau) + regG)
    aux = NewtonAux(hx=hx, hy=hy, h0=jnp.asarray(h0), cpx=cpx)

    # Random RHS (masked where appropriate).
    xi_p = jnp.asarray(rng.standard_normal(m_))
    xi_l = jnp.asarray(rng.standard_normal(n_) * lf)
    xi_u = jnp.asarray(rng.standard_normal(n_) * uf)
    xi_d = jnp.asarray(rng.standard_normal(n_))
    xi_g = jnp.asarray(rng.standard_normal())
    xi_xzl = jnp.asarray(rng.standard_normal(n_) * lf)
    xi_xzu = jnp.asarray(rng.standard_normal(n_) * uf)
    xi_tk = jnp.asarray(rng.standard_normal())

    d = solve_newton_system(dat, pt, kkt_solve, aux,
                            xi_p, xi_l, xi_u, xi_d, xi_g,
                            xi_xzl, xi_xzu, xi_tk)

    A_ = np.asarray(dat.A)
    b_ = np.asarray(dat.b)
    c_ = np.asarray(dat.c)
    dx, dxl, dxu = map(np.asarray, (d.x, d.xl, d.xu))
    dy, dzl, dzu = map(np.asarray, (d.y, d.zl, d.zu))
    dtau, dkap = float(d.tau), float(d.kappa)

    tol = 1e-7
    # 1. A dx + Rd dy - b dtau = xi_p
    r1 = A_ @ dx + 1e-10 * dy - b_ * dtau - np.asarray(xi_p)
    assert np.max(np.abs(r1)) < tol
    # 2/3. bound rows.
    r2 = (dx - dxl - ll * dtau) * lf - np.asarray(xi_l)
    r3 = (dx + dxu - uu * dtau) * uf - np.asarray(xi_u)
    assert np.max(np.abs(r2)) < tol
    assert np.max(np.abs(r3)) < tol
    # 4. -Rp dx + A'dy + dzl - dzu - c dtau = xi_d
    r4 = -1e-10 * dx + A_.T @ dy + dzl - dzu - c_ * dtau - np.asarray(xi_d)
    assert np.max(np.abs(r4)) < tol
    # 5. gap row: -c'dx + b'dy + l'dzl - u'dzu + regG dtau - dkappa = xi_g
    r5 = (-c_ @ dx + b_ @ dy + ll @ dzl - uu @ dzu + 1e-10 * dtau - dkap
          - float(xi_g))
    assert abs(r5) < tol
    # 6/7. complementarity rows.
    r6 = np.asarray(pt.zl) * dxl + np.asarray(pt.xl) * dzl - np.asarray(xi_xzl)
    r7 = np.asarray(pt.zu) * dxu + np.asarray(pt.xu) * dzu - np.asarray(xi_xzu)
    assert np.max(np.abs(r6 * lf)) < tol
    assert np.max(np.abs(r7 * uf)) < tol
    # 8. kappa dtau + tau dkappa = xi_tk
    r8 = float(pt.kappa) * dtau + float(pt.tau) * dkap - float(xi_tk)
    assert abs(r8) < tol


def test_hsd_start_and_fast_solve_options():
    """MehrotraStart / FastPredictor / FastCorrections reach the same
    optimum as the defaults (they only change where iterates start and how
    accurately the steering solves are computed)."""
    import numpy as np
    from scipy.optimize import linprog as sp_linprog

    from tulip_tpu.ipm.data import make_lp_data
    from tulip_tpu.ipm.hsd import HSDOptions, hsd_solve
    from tulip_tpu.kkt import DenseK1Backend

    rng = np.random.default_rng(7)
    m, n = 15, 30
    A = rng.standard_normal((m, n))
    u = rng.uniform(1, 4, n)
    b = A @ (u * rng.uniform(0.2, 0.8, n))
    c = rng.standard_normal(n)
    ref = sp_linprog(c, A_eq=A, b_eq=b, bounds=list(zip(np.zeros(n), u)),
                     method="highs")
    dat = make_lp_data(A, b, c, 0.0, np.zeros(n), u)
    be = DenseK1Backend(refinement_steps=1)
    for opts in (HSDOptions(MehrotraStart=True),
                 HSDOptions(FastPredictor=True, FastCorrections=True)):
        out = hsd_solve(dat, be, opts)
        assert int(out.status) == 2
        assert abs(float(out.pobj) - ref.fun) < 1e-7 * max(1.0, abs(ref.fun))

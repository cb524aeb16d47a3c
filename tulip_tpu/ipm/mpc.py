"""Mehrotra predictor-corrector IPM (no homogeneous embedding).

TPU re-design of the reference MPC solver (reference: src/IPM/MPC/MPC.jl:218-410,
src/IPM/MPC/step.jl:10-358). Same architecture as :mod:`.hsd`: the whole
iteration is pure jitted code; data-dependent loops are ``lax.while_loop``;
statuses are int32 scalars. Differences from HSD (reference: MPC.jl:1-5):

- tau ≡ 1, kappa ≡ 0; Newton system has 6 blocks, no Δτ/Δκ recovery
  (step.jl:192-194).
- Mehrotra starting point from two least-squares KKT solves
  (MPC.jl:353-410).
- Separate primal/dual step lengths αp, αd (step.jl:213-223).
- Corrector centering σ = clamp((μ_aff/μ)³, √eps, 1-√eps) (step.jl:263).
- Weaker infeasibility detection (no certificate scaling by τ).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..status import SolutionStatus, TerminationStatus
from .data import LPData, matvec, rmatvec
from .hsd import (DataNorms, HSDState, _data_norms, _tree_where,
                  full_matmul_precision)
from .point import (Point, Residuals, inf_norm, num_finite_bounds,
                    update_mu)

_UNKNOWN = int(TerminationStatus.UNKNOWN)
_OPTIMAL = int(TerminationStatus.OPTIMAL)
_PRIMAL_INFEASIBLE = int(TerminationStatus.PRIMAL_INFEASIBLE)
_DUAL_INFEASIBLE = int(TerminationStatus.DUAL_INFEASIBLE)
_ITERATION_LIMIT = int(TerminationStatus.ITERATION_LIMIT)
_NUMERICAL_PROBLEM = int(TerminationStatus.NUMERICAL_PROBLEM)

_SLN_UNKNOWN = int(SolutionStatus.UNKNOWN)
_SLN_OPTIMAL = int(SolutionStatus.OPTIMAL)
_SLN_FEASIBLE = int(SolutionStatus.FEASIBLE_POINT)
_SLN_CERTIFICATE = int(SolutionStatus.INFEASIBILITY_CERTIFICATE)


@dataclasses.dataclass(frozen=True)
class MPCOptions:
    """Static MPC options (defaults: reference src/IPM/options.jl)."""

    TolerancePFeas: float = 1.4901161193847656e-08
    ToleranceDFeas: float = 1.4901161193847656e-08
    ToleranceRGap: float = 1.4901161193847656e-08
    ToleranceIFeas: float = 1.4901161193847656e-08
    IterationsLimit: int = 100
    TimeLimit: float = float("inf")
    CorrectionLimit: int = 3
    StepDampFactor: float = 0.9995
    GammaMin: float = 0.1
    PRegMin: float = 1.4901161193847656e-08
    DRegMin: float = 1.4901161193847656e-08
    # Extra-correction parameters (reference: MPC/step.jl:282-285).
    CorrectionStepShift: float = 0.3   # δ
    CorrectionGamma: float = 0.1       # γ
    OutputLevel: int = 0


def mpc_residuals(dat: LPData, pt: Point):
    """Residuals without τ scaling (reference: MPC.jl:101-142)."""
    rp = dat.b - matvec(dat, pt.x)
    rl = (dat.l + pt.xl - pt.x) * dat.lflag
    ru = (dat.u - pt.x - pt.xu) * dat.uflag
    rd = (dat.c - rmatvec(dat, pt.y) - pt.zl * dat.lflag + pt.zu * dat.uflag)
    return rp, rl, ru, rd


def mpc_objectives(dat: LPData, pt: Point):
    pobj = jnp.dot(dat.c, pt.x) + dat.c0
    dobj = (jnp.dot(dat.b, pt.y)
            + jnp.dot(dat.l * dat.lflag, pt.zl)
            - jnp.dot(dat.u * dat.uflag, pt.zu)) + dat.c0
    return pobj, dobj


def solve_newton_system_mpc(dat: LPData, pt: Point, kkt_solve,
                            xi_p, xi_l, xi_u, xi_d, xi_xzl, xi_xzu) -> Point:
    """6-block Newton solve via one augmented solve + closed-form recovery
    (reference: src/IPM/MPC/step.jl:164-206)."""
    lf, uf = dat.lflag, dat.uflag
    xl_s = jnp.where(lf > 0, pt.xl, 1.0)
    xu_s = jnp.where(uf > 0, pt.xu, 1.0)

    xi_d_ = xi_d + (-((xi_xzl + pt.zl * xi_l) / xl_s) * lf
                    + ((xi_xzu - pt.zu * xi_u) / xu_s) * uf)
    dx, dy = kkt_solve(xi_p, xi_d_)

    dxl = (-xi_l + dx) * lf
    dxu = (xi_u - dx) * uf
    dzl = ((xi_xzl - pt.zl * dxl) / xl_s) * lf
    dzu = ((xi_xzu - pt.zu * dxu) / xu_s) * uf

    zero = jnp.zeros((), dtype=dx.dtype)
    return Point(x=dx, xl=dxl, xu=dxu, y=dy, zl=dzl, zu=dzu,
                 tau=zero, kappa=zero, mu=zero)


def max_step_length_pd(dat: LPData, pt: Point, delta: Point,
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Separate primal and dual ratio tests (reference: step.jl:213-223)."""
    inf = jnp.asarray(jnp.inf, dtype=pt.x.dtype)

    def ratio(x, dx, mask):
        neg = (dx < 0) & (mask > 0)
        r = jnp.where(neg, -x / jnp.where(neg, dx, -1.0), inf)
        return jnp.min(r, initial=jnp.inf)

    one = jnp.ones((), dtype=pt.x.dtype)
    ap = jnp.minimum(one, jnp.minimum(ratio(pt.xl, delta.xl, dat.lflag),
                                      ratio(pt.xu, delta.xu, dat.uflag)))
    ad = jnp.minimum(one, jnp.minimum(ratio(pt.zl, delta.zl, dat.lflag),
                                      ratio(pt.zu, delta.zu, dat.uflag)))
    return ap, ad


def mpc_starting_point(dat: LPData, backend, kkt) -> Tuple[Point, object]:
    """Mehrotra starting point (reference: src/IPM/MPC/MPC.jl:353-410):
    two least-squares KKT solves, positivity shifts, complementarity
    balancing."""
    dt = dat.c.dtype
    m, n = dat.nrow, dat.ncol
    lf, uf = dat.lflag, dat.uflag
    zeros_n = jnp.zeros(n, dtype=dt)
    one = jnp.ones((), dtype=dt)

    kkt, _ok = backend.update(kkt, zeros_n, jnp.ones(n, dtype=dt),
                              jnp.full(m, 1e-6, dtype=dt))
    _, y = backend.solve(kkt, jnp.zeros(m, dtype=dt), dat.c)
    x, _ = backend.solve(kkt, dat.b, zeros_n)

    dx_shift = one + jnp.maximum(
        jnp.zeros((), dt),
        jnp.maximum(-1.5 * jnp.min((x - dat.l) * lf, initial=jnp.inf),
                    -1.5 * jnp.min((dat.u - x) * uf, initial=jnp.inf)))
    xl = ((x - dat.l) + dx_shift) * lf
    xu = ((dat.u - x) + dx_shift) * uf

    z = dat.c - rmatvec(dat, y)
    denom = jnp.maximum(lf + uf, 1.0)
    zl = (z / denom) * lf
    zu = (-z / denom) * uf
    dz_shift = one + jnp.maximum(
        jnp.zeros((), dt),
        jnp.maximum(-1.5 * jnp.min(zl, initial=jnp.inf),
                    -1.5 * jnp.min(zu, initial=jnp.inf)))
    zl = zl + dz_shift * lf
    zu = zu + dz_shift * uf

    # Balance complementarity products (MPC.jl:396-404).
    mu0 = jnp.dot(xl, zl) + jnp.dot(xu, zu)
    sz = jnp.sum(zl) + jnp.sum(zu)
    sx = jnp.sum(xl) + jnp.sum(xu)
    dxb = mu0 / jnp.maximum(2 * sz, 1e-300)
    dzb = mu0 / jnp.maximum(2 * sx, 1e-300)
    xl = xl + dxb * lf
    xu = xu + dxb * uf
    zl = zl + dzb * lf
    zu = zu + dzb * uf

    pt = Point(x=x, xl=xl, xu=xu, y=y, zl=zl, zu=zu,
               tau=jnp.ones((), dt), kappa=jnp.zeros((), dt),
               mu=jnp.ones((), dt))
    return update_mu(pt, dat, hflag=False), kkt


def compute_step_mpc(backend, opts: MPCOptions, dat: LPData, state: HSDState,
                     ) -> HSDState:
    """One MPC step (reference: src/IPM/MPC/step.jl:10-123)."""
    pt, res = state.pt, state.res
    lf, uf = dat.lflag, dat.uflag
    dt = pt.x.dtype
    one = jnp.ones((), dtype=dt)
    p = num_finite_bounds(dat)
    sqeps = float(np.sqrt(np.finfo(np.dtype(dt.name)).eps))

    xl_s = jnp.where(lf > 0, pt.xl, 1.0)
    xu_s = jnp.where(uf > 0, pt.xu, 1.0)
    theta_l = (pt.zl / xl_s) * lf
    theta_u = (pt.zu / xu_s) * uf
    theta_inv = theta_l + theta_u

    # Regularization decay, clamped to [sqrt(eps), 1] (step.jl:29-32).
    regP = jnp.clip(state.regP / 10.0, opts.PRegMin, 1.0)
    regD = jnp.clip(state.regD / 10.0, opts.DRegMin, 1.0)

    kkt0, ok0 = backend.update(state.kkt, theta_inv, regP, regD)

    def bump_cond(c):
        _, _, _, ok, nbump = c
        return (~ok) & (nbump < 3)

    def bump_body(c):
        kkt, rp, rd, ok, nbump = c
        rp = rp * 100.0
        rd = rd * 100.0
        kkt, ok = backend.update(kkt, theta_inv, rp, rd)
        return kkt, rp, rd, ok, nbump + 1

    kkt, regP, regD, fact_ok, _ = jax.lax.while_loop(
        bump_cond, bump_body,
        (kkt0, regP, regD, ok0, jnp.zeros((), jnp.int32)))

    kkt_solve = partial(backend.solve, kkt)

    rp, rl, ru, rd = res.rp, res.rl, res.ru, res.rd

    # Predictor (step.jl:229-246).
    delta = solve_newton_system_mpc(
        dat, pt, kkt_solve, rp, rl, ru, rd,
        -(pt.xl * pt.zl) * lf, -(pt.xu * pt.zu) * uf)
    ap, ad = max_step_length_pd(dat, pt, delta)

    # Corrector (step.jl:251-277).
    # p = 0 (all variables free): no complementarity — mu_aff and the
    # centering ratio are 0 by convention rather than 0/0 = NaN; sigma
    # clamps to its sqeps floor and the corrector reduces to feasibility.
    mu_aff = (jnp.dot((pt.xl + ap * delta.xl) * lf, pt.zl + ad * delta.zl)
              + jnp.dot((pt.xu + ap * delta.xu) * uf,
                        pt.zu + ad * delta.zu)) / jnp.maximum(p, 1.0)
    mu_ratio = jnp.where(pt.mu > 0, mu_aff / jnp.where(pt.mu > 0, pt.mu, 1.0),
                         0.0)
    sigma = jnp.clip(mu_ratio ** 3, sqeps, 1.0 - sqeps)
    delta_c = solve_newton_system_mpc(
        dat, pt, kkt_solve, rp, rl, ru, rd,
        (sigma * pt.mu - delta.xl * delta.zl - pt.xl * pt.zl) * lf,
        (sigma * pt.mu - delta.xu * delta.zu - pt.xu * pt.zu) * uf)
    ap, ad = max_step_length_pd(dat, pt, delta_c)
    delta = delta_c

    # Extra centrality corrections (step.jl:85-109, 282-358): RHS has zero
    # p/l/u/d blocks; accepted only if BOTH step lengths grow >= 1%.
    gam = opts.CorrectionGamma
    shift = opts.CorrectionStepShift
    zero_m = jnp.zeros_like(pt.y)
    zero_n = jnp.zeros_like(pt.x)

    def corr_cond(c):
        _, _, _, ncor, done = c
        return (ncor < opts.CorrectionLimit) & (~done)

    def corr_body(c):
        delta, ap, ad, ncor, _ = c
        ap_ = jnp.minimum(ap + shift, one)
        ad_ = jnp.minimum(ad + shift, one)

        g = jnp.dot(pt.xl, pt.zl) + jnp.dot(pt.xu, pt.zu)
        ga = (jnp.dot((pt.xl + ap * delta.xl) * lf, pt.zl + ad * delta.zl)
              + jnp.dot((pt.xu + ap * delta.xu) * uf,
                        pt.zu + ad * delta.zu))
        mu_t = (ga / g) * (ga / g) * (ga / p)

        tmin, tmax = mu_t * gam, mu_t / gam

        def target(x, dxv, z, dzv, mask):
            v = (x + ap_ * dxv) * (z + ad_ * dzv)
            return jnp.where(v < tmin, tmin - v,
                             jnp.where(v > tmax, tmax - v, 0.0)) * mask

        xzl = target(pt.xl, delta.xl, pt.zl, delta.zl, lf)
        xzu = target(pt.xu, delta.xu, pt.zu, delta.zu, uf)

        dc = solve_newton_system_mpc(dat, pt, kkt_solve,
                                     zero_m, zero_n, zero_n, zero_n,
                                     xzl, xzu)
        dc = Point(x=dc.x + delta.x, xl=dc.xl + delta.xl,
                   xu=dc.xu + delta.xu, y=dc.y + delta.y,
                   zl=dc.zl + delta.zl, zu=dc.zu + delta.zu,
                   tau=dc.tau, kappa=dc.kappa, mu=dc.mu)
        ap_c, ad_c = max_step_length_pd(dat, pt, dc)
        accept = (ap_c >= 1.01 * ap) & (ad_c >= 1.01 * ad)
        delta = _tree_where(accept, dc, delta)
        ap = jnp.where(accept, ap_c, ap)
        ad = jnp.where(accept, ad_c, ad)
        return delta, ap, ad, ncor + 1, ~accept

    delta, ap, ad, _, _ = jax.lax.while_loop(
        corr_cond, corr_body,
        (delta, ap, ad, jnp.zeros((), jnp.int32), jnp.zeros((), bool)))

    # Damped update with separate primal/dual lengths (step.jl:111-120).
    ap = ap * opts.StepDampFactor
    ad = ad * opts.StepDampFactor
    pt_new = Point(
        x=pt.x + ap * delta.x,
        xl=pt.xl + ap * delta.xl,
        xu=pt.xu + ap * delta.xu,
        y=pt.y + ad * delta.y,
        zl=pt.zl + ad * delta.zl,
        zu=pt.zu + ad * delta.zu,
        tau=pt.tau, kappa=pt.kappa, mu=pt.mu)
    pt_new = update_mu(pt_new, dat, hflag=False)

    pt_out = _tree_where(fact_ok, pt_new, pt)
    status = jnp.where(fact_ok, state.status,
                       jnp.asarray(_NUMERICAL_PROBLEM, jnp.int32))
    niter = jnp.where(fact_ok, state.niter + 1, state.niter)
    return state._replace(pt=pt_out, regP=regP, regD=regD, kkt=kkt,
                          niter=niter, status=status)


def update_status_mpc(dat: LPData, opts: MPCOptions, norms: DataNorms,
                      state: HSDState) -> HSDState:
    """Optimality + (weaker) infeasibility tests
    (reference: src/IPM/MPC/MPC.jl:150-211)."""
    pt, res = state.pt, state.res
    one = jnp.ones((), dtype=pt.x.dtype)

    pobj, dobj = mpc_objectives(dat, pt)

    rho_p = jnp.maximum(
        res.rp_nrm / (one + norms.b),
        jnp.maximum(res.rl_nrm / (one + norms.l),
                    res.ru_nrm / (one + norms.u)))
    rho_d = res.rd_nrm / (one + norms.c)
    rho_g = jnp.abs(pobj - dobj) / (one + jnp.abs(pobj))

    p_feas = rho_p <= opts.TolerancePFeas
    d_feas = rho_d <= opts.ToleranceDFeas
    # Divergence guard (round-5 fuzz finding): on an unbounded LP the
    # iterate runs off along the recession direction with Ax = b intact;
    # the RELATIVE gap/residual tests — everything divided by
    # (1 + |pobj|) — then fire spuriously once |pobj| ~ 1/eps and MPC
    # declared a wrong OPTIMAL with x ~ inf. An optimal claim now
    # requires finite objectives and an iterate within 1/eps; otherwise
    # the loop continues to ITERATION_LIMIT or the (weaker, reference-
    # parity) infeasibility tests below fire.
    diverge = jnp.asarray(1.0, pt.x.dtype) / jnp.finfo(pt.x.dtype).eps
    finite = (jnp.isfinite(pobj) & jnp.isfinite(dobj)
              & (inf_norm(pt.x) < diverge))
    optimal = p_feas & d_feas & (rho_g <= opts.ToleranceRGap) & finite

    ray_nrm = jnp.maximum(
        inf_norm(matvec(dat, pt.x)),
        jnp.maximum(inf_norm((pt.x - pt.xl) * dat.lflag),
                    inf_norm((pt.x + pt.xu) * dat.uflag)))
    dual_infeas = (ray_nrm * (norms.c / jnp.maximum(one, norms.b))
                   < -opts.ToleranceIFeas * jnp.dot(dat.c, pt.x))

    dlt = (rmatvec(dat, pt.y) + pt.zl * dat.lflag - pt.zu * dat.uflag)
    farkas_obj = (jnp.dot(dat.b, pt.y)
                  + jnp.dot(dat.l * dat.lflag, pt.zl)
                  - jnp.dot(dat.u * dat.uflag, pt.zu))
    primal_infeas = (inf_norm(dlt)
                     * jnp.maximum(jnp.maximum(norms.l, norms.u), norms.b)
                     / jnp.maximum(one, norms.c)
                     < farkas_obj * opts.ToleranceIFeas)

    status = jnp.where(
        optimal, _OPTIMAL,
        jnp.where(dual_infeas, _DUAL_INFEASIBLE,
                  jnp.where(primal_infeas, _PRIMAL_INFEASIBLE,
                            _UNKNOWN))).astype(jnp.int32)
    primal_status = jnp.where(
        optimal, _SLN_OPTIMAL,
        jnp.where(dual_infeas, _SLN_CERTIFICATE,
                  jnp.where(p_feas, _SLN_FEASIBLE, _SLN_UNKNOWN))
    ).astype(jnp.int32)
    dual_status = jnp.where(
        optimal, _SLN_OPTIMAL,
        jnp.where(primal_infeas, _SLN_CERTIFICATE,
                  jnp.where(d_feas, _SLN_FEASIBLE, _SLN_UNKNOWN))
    ).astype(jnp.int32)

    return state._replace(status=status, primal_status=primal_status,
                          dual_status=dual_status, pobj=pobj, dobj=dobj)


def _mpc_residual_state(dat, state):
    rp, rl, ru, rd = mpc_residuals(dat, state.pt)
    res = Residuals(rp=rp, rl=rl, ru=ru, rd=rd,
                    rg=jnp.zeros((), rp.dtype),
                    rp_nrm=inf_norm(rp), rl_nrm=inf_norm(rl),
                    ru_nrm=inf_norm(ru), rd_nrm=inf_norm(rd),
                    rg_nrm=jnp.zeros((), rp.dtype))
    pt = update_mu(state.pt, dat, hflag=False)
    return state._replace(pt=pt, res=res)


def mpc_iteration(backend, opts: MPCOptions, dat: LPData, state: HSDState,
                  ) -> HSDState:
    norms = _data_norms(dat)
    state = _mpc_residual_state(dat, state)
    state = update_status_mpc(dat, opts, norms, state)
    state = state._replace(status=jnp.where(
        (state.status == _UNKNOWN) & (state.niter >= opts.IterationsLimit),
        jnp.asarray(_ITERATION_LIMIT, jnp.int32), state.status))
    return jax.lax.cond(
        state.status == _UNKNOWN,
        lambda s: compute_step_mpc(backend, opts, dat, s),
        lambda s: s,
        state)


def init_state_mpc(dat: LPData, backend) -> HSDState:
    dt = dat.c.dtype
    kkt = backend.setup_data(dat)
    pt, kkt = mpc_starting_point(dat, backend, kkt)
    state = HSDState(
        pt=pt, res=None,
        regP=jnp.ones(dat.ncol, dtype=dt),
        regD=jnp.ones(dat.nrow, dtype=dt),
        regG=jnp.zeros((), dtype=dt),
        kkt=kkt,
        niter=jnp.zeros((), jnp.int32),
        status=jnp.asarray(_UNKNOWN, jnp.int32),
        primal_status=jnp.asarray(_SLN_UNKNOWN, jnp.int32),
        dual_status=jnp.asarray(_SLN_UNKNOWN, jnp.int32),
        pobj=jnp.asarray(jnp.inf, dt),
        dobj=jnp.asarray(-jnp.inf, dt),
    )
    return _mpc_residual_state(dat, state)


@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def _mpc_iteration_jit(backend, opts, dat, state):
    return mpc_iteration(backend, opts, dat, state)


@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def mpc_solve_device(backend, opts: MPCOptions, dat: LPData,
                     state: Optional[HSDState] = None) -> HSDState:
    if state is None:
        state = init_state_mpc(dat, backend)

    def cond(s):
        return s.status == _UNKNOWN

    def body(s):
        return mpc_iteration(backend, opts, dat, s)

    return jax.lax.while_loop(cond, body, state)


def mpc_solve(dat: LPData, backend, opts: MPCOptions, log_fn=None) -> HSDState:
    """Host-driven MPC solve (reference: MPC.jl:218-351)."""
    if opts.OutputLevel == 0 and log_fn is None \
            and opts.TimeLimit == float("inf"):
        # init_state_mpc runs eagerly: backends with host-side symbolic
        # analysis (banded/tiled-sparse/SMW plans) must see concrete
        # arrays in setup.
        state0 = full_matmul_precision(init_state_mpc)(dat, backend)
        return jax.block_until_ready(
            mpc_solve_device(backend, opts, dat, state0))

    state = full_matmul_precision(init_state_mpc)(dat, backend)
    tstart = time.time()
    if opts.OutputLevel > 0:
        print("\nOptimizer info (MPC)")
        print(f"Constraints  : {dat.nrow}")
        print(f"Variables    : {dat.ncol}")
        print("Linear solver:")
        print(f"  Arithmetic : {backend.arithmetic_label(dat.c.dtype)}")
        print(f"  Backend    : {backend.name}")
        print(f"  System     : {backend.linear_system()}")
        print(f"\n{'Itn':>4}  {'PObj':>14}  {'DObj':>14}  "
              f"{'PFeas':>8} {'DFeas':>8}  {'Mu':>7}  Time")

    prev_niter = -1
    while True:
        n_entry = int(state.niter)
        state = jax.block_until_ready(
            _mpc_iteration_jit(backend, opts, dat, state))
        ttot = time.time() - tstart
        if opts.OutputLevel > 0:
            print(f"{n_entry:4d}  {float(state.pobj):+14.7e}  "
                  f"{float(state.dobj):+14.7e}  "
                  f"{float(state.res.rp_nrm):8.2e} "
                  f"{float(state.res.rd_nrm):8.2e}  "
                  f"{float(state.pt.mu):7.1e}  {ttot:.2f}")
        if log_fn is not None:
            log_fn(state)
        if int(state.status) != _UNKNOWN:
            break
        if int(state.niter) == prev_niter:
            break
        prev_niter = int(state.niter)
        if ttot >= opts.TimeLimit:
            state = state._replace(status=jnp.asarray(
                int(TerminationStatus.TIME_LIMIT), jnp.int32))
            break

    if opts.OutputLevel > 0:
        print(f"Solver exited with status "
              f"{TerminationStatus(int(state.status)).name}")
    return state

"""Homogeneous self-dual interior-point method, as jitted device code.

Re-designs the reference HSD solver (reference: src/IPM/HSD/HSD.jl:203-350,
src/IPM/HSD/step.jl:10-401) for accelerator execution:

- The whole iteration (residuals → convergence/certificate tests → KKT
  factorize+solve → predictor/corrector → centrality corrections → damped
  update) is ONE pure jitted function over pytrees.
- All of the reference's data-dependent control flow is value-level:
  the factorization-failure regularization ladder (step.jl:34-51) is a
  ``lax.while_loop`` on a success flag; the centrality-correction loop
  (step.jl:103-136) a ``lax.while_loop`` with an acceptance mask; the
  early-exit step-length ratio loops (step.jl:274-306) masked min-reductions;
  termination statuses int32 scalars.
- Because the step is pure, ``vmap`` gives scenario-batched solves and
  ``shard_map`` gives multi-chip solves without touching this file.

Two drivers: ``hsd_solve`` (host loop around the jitted iteration; supports
logging and wall-clock limits like the reference) and the fully-device
``lax.while_loop`` path used by the batched solver.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..status import SolutionStatus, TerminationStatus
from .data import LPData, matvec, rmatvec
from .point import (Point, Residuals, compute_residuals, dual_objective,
                    inf_norm, num_finite_bounds, primal_objective,
                    starting_point, update_mu)

# Termination codes as plain ints for use inside jit.
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
class HSDOptions:
    """Static solver options (hashable → jit static arg).

    Defaults mirror the reference (reference: src/IPM/options.jl:1-25);
    tolerance/regularization fields must be pre-resolved floats.
    """

    TolerancePFeas: float = 1.4901161193847656e-08
    ToleranceDFeas: float = 1.4901161193847656e-08
    ToleranceRGap: float = 1.4901161193847656e-08
    ToleranceIFeas: float = 1.4901161193847656e-08
    IterationsLimit: int = 100
    TimeLimit: float = float("inf")
    CorrectionLimit: int = 3
    StepDampFactor: float = 0.9995
    GammaMin: float = 0.1
    CentralityOutlierThreshold: float = 0.1
    PRegMin: float = 1.4901161193847656e-08
    DRegMin: float = 1.4901161193847656e-08
    OutputLevel: int = 0
    # Start from the Mehrotra least-squares point (reference:
    # src/IPM/MPC/MPC.jl:353-410 — the reference only uses it for MPC; its
    # HSD always cold-starts at ones, HSD.jl:238-249). Off by default for
    # reference parity. For batched solves it compresses the iteration-count
    # tail that sets the vmapped while_loop's wall-clock.
    MehrotraStart: bool = False
    # Solve the affine-scaling predictor / the extra centrality corrections
    # with the backend's UNREFINED base solve (skipping its iterative-
    # refinement sweeps). The predictor only sets the centering weight γ via
    # its step length, and a correction is only accepted when it grows the
    # step, so lower accuracy there degrades gracefully while the corrector
    # direction — the one actually taken — keeps full accuracy. Cuts the
    # per-iteration op count by ~2 refinement sweeps; significant on
    # latency-bound platforms. Off by default (reference applies equal
    # accuracy everywhere).
    FastPredictor: bool = False
    FastCorrections: bool = False


class HSDState(NamedTuple):
    """Full solver state; a pytree so it flows through while_loop/vmap."""

    pt: Point
    res: Residuals
    regP: jnp.ndarray      # (n,)
    regD: jnp.ndarray      # (m,)
    regG: jnp.ndarray      # scalar
    kkt: Any               # backend state pytree
    niter: jnp.ndarray     # int32
    status: jnp.ndarray    # int32 TerminationStatus
    primal_status: jnp.ndarray  # int32 SolutionStatus
    dual_status: jnp.ndarray    # int32 SolutionStatus
    pobj: jnp.ndarray      # scalar
    dobj: jnp.ndarray      # scalar


class DataNorms(NamedTuple):
    """Inf-norms of problem data, precomputed once per solve."""

    b: jnp.ndarray
    c: jnp.ndarray
    l: jnp.ndarray  # of l*lflag
    u: jnp.ndarray  # of u*uflag


def _data_norms(dat: LPData) -> DataNorms:
    return DataNorms(
        b=inf_norm(dat.b), c=inf_norm(dat.c),
        l=inf_norm(dat.l * dat.lflag), u=inf_norm(dat.u * dat.uflag),
    )


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b)


def full_matmul_precision(fn):
    """Trace ``fn`` with true-f32 matmuls. On the GPU an f32 matmul
    otherwise runs in TF32 (about three decimal digits); the IPM's normal
    equations and backsolves need full precision or convergence stalls
    near tolerance."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Newton system
# ---------------------------------------------------------------------------

class NewtonAux(NamedTuple):
    """Per-iteration constants for Δτ recovery: the preliminary augmented
    solve (hx, hy), the scalar denominator h0, and the combined objective
    vector cpx = c + Θl·l + Θu·u (reference: src/IPM/HSD/step.jl:58-76)."""

    hx: jnp.ndarray
    hy: jnp.ndarray
    h0: jnp.ndarray
    cpx: jnp.ndarray


def augmented_rhs(dat: LPData, pt: Point, xi_l, xi_u, xi_d, xi_xzl, xi_xzu):
    """Modified dual RHS of the reduced augmented system
    (reference: src/IPM/HSD/step.jl:210-214). Split out so callers can
    batch several independent Newton solves into ONE multi-RHS KKT solve."""
    lf, uf = dat.lflag, dat.uflag
    xl_s = jnp.where(lf > 0, pt.xl, 1.0)
    xu_s = jnp.where(uf > 0, pt.xu, 1.0)
    return xi_d + (-((xi_xzl + pt.zl * xi_l) / xl_s) * lf
                   + ((xi_xzu - pt.zu * xi_u) / xu_s) * uf)


def solve_newton_system(dat: LPData, pt: Point, kkt_solve, aux: NewtonAux,
                        xi_p, xi_l, xi_u, xi_d, xi_g, xi_xzl, xi_xzu, xi_tk,
                        solved=None) -> Point:
    """Solve the 8-block HSD Newton system by reduction to one augmented
    solve plus closed-form recovery (reference: src/IPM/HSD/step.jl:198-266).

    ``solved``: optional precomputed (dx, dy) of the augmented system with
    RHS (xi_p, augmented_rhs(...)) — lets the caller fuse this solve into
    a multi-RHS batch.
    """
    lf, uf = dat.lflag, dat.uflag
    xl_s = jnp.where(lf > 0, pt.xl, 1.0)
    xu_s = jnp.where(uf > 0, pt.xu, 1.0)
    ll = dat.l * lf
    uu = dat.u * uf

    # I. Augmented solve with modified dual RHS (step.jl:210-214).
    if solved is None:
        xi_d_ = augmented_rhs(dat, pt, xi_l, xi_u, xi_d, xi_xzl, xi_xzu)
        dx, dy = kkt_solve(xi_p, xi_d_)
    else:
        dx, dy = solved

    # II. Recover Δτ (step.jl:218-233).
    xi_g_ = (xi_g + xi_tk / pt.tau
             - jnp.dot((xi_xzl / xl_s) * lf, ll)
             + jnp.dot((xi_xzu / xu_s) * uf, uu)
             - jnp.dot(((pt.zl / xl_s) * xi_l) * lf, ll)
             - jnp.dot(((pt.zu / xu_s) * xi_u) * uf, uu))
    dtau = (xi_g_ + jnp.dot(aux.cpx, dx) - jnp.dot(dat.b, dy)) / aux.h0

    dx = dx + dtau * aux.hx
    dy = dy + dtau * aux.hy

    # III. Recover bound slacks (step.jl:240-245).
    dxl = (-xi_l + dx - dtau * ll) * lf
    dxu = (xi_u - dx + dtau * uu) * uf

    # IV. Recover bound duals (step.jl:248-249).
    dzl = ((xi_xzl - pt.zl * dxl) / xl_s) * lf
    dzu = ((xi_xzu - pt.zu * dxu) / xu_s) * uf

    # V. Recover Δκ (step.jl:252).
    dkappa = (xi_tk - pt.kappa * dtau) / pt.tau

    zero = jnp.zeros((), dtype=dx.dtype)
    return Point(x=dx, xl=dxl, xu=dxu, y=dy, zl=dzl, zu=dzu,
                 tau=dtau, kappa=dkappa, mu=zero)


def max_step_length(dat: LPData, pt: Point, delta: Point) -> jnp.ndarray:
    """max a >= 0 with pt + a*delta >= 0 on all nonnegative coordinates, as
    masked min-reductions (reference: src/IPM/HSD/step.jl:274-306)."""
    inf = jnp.asarray(jnp.inf, dtype=pt.x.dtype)

    def ratio(x, dx, mask):
        neg = (dx < 0) & (mask > 0)
        r = jnp.where(neg, -x / jnp.where(neg, dx, -1.0), inf)
        return jnp.min(r, initial=jnp.inf)

    axl = ratio(pt.xl, delta.xl, dat.lflag)
    axu = ratio(pt.xu, delta.xu, dat.uflag)
    azl = ratio(pt.zl, delta.zl, dat.lflag)
    azu = ratio(pt.zu, delta.zu, dat.uflag)
    at = jnp.where(delta.tau < 0, -pt.tau / jnp.where(delta.tau < 0, delta.tau, -1.0), 1.0)
    ak = jnp.where(delta.kappa < 0, -pt.kappa / jnp.where(delta.kappa < 0, delta.kappa, -1.0), 1.0)
    one = jnp.ones((), dtype=pt.x.dtype)
    return jnp.minimum(one, jnp.minimum(
        jnp.minimum(jnp.minimum(axl, axu), jnp.minimum(azl, azu)),
        jnp.minimum(at, ak)))


def _higher_corrector(dat: LPData, opts: HSDOptions, pt: Point, kkt_solve,
                      aux: NewtonAux, gamma, delta: Point, alpha,
                      ) -> Tuple[Point, jnp.ndarray]:
    """Gondzio-style centrality correction: clip outlier complementarity
    products at a trial point back toward [βγμ, γμ/β] and take one more
    Newton solve (reference: src/IPM/HSD/step.jl:325-401)."""
    lf, uf = dat.lflag, dat.uflag
    beta = opts.CentralityOutlierThreshold
    one = jnp.ones((), dtype=pt.x.dtype)

    a_ = jnp.minimum(one, 2.0 * alpha)

    vl = ((pt.xl + a_ * delta.xl) * (pt.zl + a_ * delta.zl)) * lf
    vu = ((pt.xu + a_ * delta.xu) * (pt.zu + a_ * delta.zu)) * uf
    vt = (pt.tau + a_ * delta.tau) * (pt.kappa + a_ * delta.kappa)

    mu_l = beta * pt.mu * gamma
    mu_u = gamma * pt.mu / beta

    def clip(v):
        return jnp.where(v < mu_l, mu_l - v,
                         jnp.where(v > mu_u, mu_u - v, 0.0))

    vl = clip(vl) * lf
    vu = clip(vu) * uf
    vt = clip(vt)

    # Project target to v'e = 0 (step.jl:373-377).
    p = num_finite_bounds(dat)
    dshift = (jnp.sum(vl) + jnp.sum(vu) + vt) / (p + 1.0)
    vl = (vl - dshift) * lf
    vu = (vu - dshift) * uf
    vt = vt - dshift

    zero_m = jnp.zeros_like(pt.y)
    zero_n = jnp.zeros_like(pt.x)
    zero = jnp.zeros((), dtype=pt.x.dtype)
    dc = solve_newton_system(dat, pt, kkt_solve, aux,
                             zero_m, zero_n, zero_n, zero_n, zero,
                             vl, vu, vt)
    dc = Point(x=dc.x + delta.x, xl=dc.xl + delta.xl, xu=dc.xu + delta.xu,
               y=dc.y + delta.y, zl=dc.zl + delta.zl, zu=dc.zu + delta.zu,
               tau=dc.tau + delta.tau, kappa=dc.kappa + delta.kappa,
               mu=dc.mu)
    alpha_c = max_step_length(dat, pt, dc)
    return dc, alpha_c


# ---------------------------------------------------------------------------
# One HSD step
# ---------------------------------------------------------------------------

def compute_step(backend, opts: HSDOptions, dat: LPData, state: HSDState,
                 ) -> HSDState:
    """One full HSD step (reference: src/IPM/HSD/step.jl:10-151)."""
    pt, res = state.pt, state.res
    lf, uf = dat.lflag, dat.uflag
    dt = pt.x.dtype
    one = jnp.ones((), dtype=dt)

    xl_s = jnp.where(lf > 0, pt.xl, 1.0)
    xu_s = jnp.where(uf > 0, pt.xu, 1.0)
    theta_l = (pt.zl / xl_s) * lf
    theta_u = (pt.zu / xu_s) * uf
    theta_inv = theta_l + theta_u

    # Regularization decay (step.jl:29-31).
    regP = jnp.maximum(opts.PRegMin, state.regP / 10.0)
    regD = jnp.maximum(opts.DRegMin, state.regD / 10.0)
    regG = jnp.maximum(opts.PRegMin, state.regG / 10.0)

    # Factorization with up to 3 ×100 regularization bumps on failure
    # (step.jl:34-51), as a while_loop on the success flag.
    kkt0, ok0 = backend.update(state.kkt, theta_inv, regP, regD)

    def bump_cond(c):
        _, _, _, _, ok, nbump = c
        return (~ok) & (nbump < 3)

    def bump_body(c):
        kkt, rp, rd, rg, ok, nbump = c
        rp = rp * 100.0
        rd = rd * 100.0
        rg = rg * 100.0
        kkt, ok = backend.update(kkt, theta_inv, rp, rd)
        return kkt, rp, rd, rg, ok, nbump + 1

    kkt, regP, regD, regG, fact_ok, _ = jax.lax.while_loop(
        bump_cond, bump_body,
        (kkt0, regP, regD, regG, ok0, jnp.zeros((), jnp.int32)))

    kkt_solve = partial(backend.solve, kkt)
    kkt_solve_pred = (partial(backend.solve_unrefined, kkt)
                      if opts.FastPredictor else kkt_solve)
    kkt_solve_corr = (partial(backend.solve_unrefined, kkt)
                      if opts.FastCorrections else kkt_solve)

    ll = dat.l * lf
    uu = dat.u * uf

    # Preliminary solve enabling Δτ recovery (step.jl:58-76).
    # (A 2-RHS fusion with the predictor solve — vmap over stacked RHS —
    # was measured SLOWER on this image's per-op-latency-bound platform:
    # 14.2k vs 15.8k solves/s on the 2048-LP bench; the stack/slice ops
    # and the vmapped backsolve lowering cost more than the saved chain.
    # augmented_rhs/solved= support remains for multi-RHS callers.)
    xi_ = dat.c - theta_l * ll - theta_u * uu
    hx, hy = kkt_solve(dat.b, xi_)
    cpx = dat.c + theta_l * ll + theta_u * uu
    h0 = (jnp.dot(ll, ll * theta_l) + jnp.dot(uu, uu * theta_u)
          - jnp.dot(cpx, hx) + jnp.dot(dat.b, hy)
          + pt.kappa / pt.tau + regG)
    aux = NewtonAux(hx=hx, hy=hy, h0=h0, cpx=cpx)

    # Affine-scaling predictor (step.jl:79-85).
    delta = solve_newton_system(
        dat, pt, kkt_solve_pred, aux,
        res.rp, res.rl, res.ru, res.rd, res.rg,
        -(pt.xl * pt.zl) * lf,
        -(pt.xu * pt.zu) * uf,
        -pt.tau * pt.kappa)

    alpha = max_step_length(dat, pt, delta)
    gamma = (one - alpha) ** 2 * jnp.minimum(one - alpha, opts.GammaMin)
    eta = one - gamma

    # Mehrotra corrector (step.jl:93-99).
    delta = solve_newton_system(
        dat, pt, kkt_solve, aux,
        eta * res.rp, eta * res.rl, eta * res.ru, eta * res.rd, eta * res.rg,
        (-pt.xl * pt.zl + gamma * pt.mu - delta.xl * delta.zl) * lf,
        (-pt.xu * pt.zu + gamma * pt.mu - delta.xu * delta.zu) * uf,
        -pt.tau * pt.kappa + gamma * pt.mu - delta.tau * delta.kappa)
    alpha = max_step_length(dat, pt, delta)

    # Extra centrality corrections (step.jl:103-136).
    def corr_cond(c):
        _, alpha, ncor, done = c
        return (ncor < opts.CorrectionLimit) & (alpha < 0.999) & (~done)

    def corr_body(c):
        delta, alpha, ncor, _ = c
        a_prev = alpha
        dc, ac = _higher_corrector(dat, opts, pt, kkt_solve_corr, aux, gamma,
                                   delta, a_prev)
        use = ac > a_prev
        delta = _tree_where(use, dc, delta)
        alpha = jnp.where(use, ac, alpha)
        done = ac < 1.1 * a_prev
        return delta, alpha, ncor + 1, done

    delta, alpha, _, _ = jax.lax.while_loop(
        corr_cond, corr_body,
        (delta, alpha, jnp.zeros((), jnp.int32), jnp.zeros((), bool)))

    # Damped update (step.jl:139-148).
    alpha = alpha * opts.StepDampFactor
    pt_new = Point(
        x=pt.x + alpha * delta.x,
        xl=pt.xl + alpha * delta.xl,
        xu=pt.xu + alpha * delta.xu,
        y=pt.y + alpha * delta.y,
        zl=pt.zl + alpha * delta.zl,
        zu=pt.zu + alpha * delta.zu,
        tau=pt.tau + alpha * delta.tau,
        kappa=pt.kappa + alpha * delta.kappa,
        mu=pt.mu)
    pt_new = update_mu(pt_new, dat, hflag=True)

    # Factorization failure after all bumps → numerical-problem status
    # (HSD.jl:319-326): keep the old point, flag the state.
    pt_out = _tree_where(fact_ok, pt_new, pt)
    status = jnp.where(fact_ok, state.status,
                       jnp.asarray(_NUMERICAL_PROBLEM, jnp.int32))
    niter = jnp.where(fact_ok, state.niter + 1, state.niter)

    return state._replace(pt=pt_out, regP=regP, regD=regD, regG=regG,
                          kkt=kkt, niter=niter, status=status)


# ---------------------------------------------------------------------------
# Convergence / certificate tests
# ---------------------------------------------------------------------------

def update_status(dat: LPData, opts: HSDOptions, norms: DataNorms,
                  state: HSDState) -> HSDState:
    """Optimality test + unboundedness and Farkas-infeasibility certificate
    tests (reference: src/IPM/HSD/HSD.jl:136-196)."""
    pt, res = state.pt, state.res
    one = jnp.ones((), dtype=pt.x.dtype)

    pobj = primal_objective(dat, pt)
    dobj = dual_objective(dat, pt)

    rho_p = jnp.maximum(
        res.rp_nrm / (pt.tau * (one + norms.b)),
        jnp.maximum(res.rl_nrm / (pt.tau * (one + norms.l)),
                    res.ru_nrm / (pt.tau * (one + norms.u))))
    rho_d = res.rd_nrm / (pt.tau * (one + norms.c))
    rho_g = jnp.abs(pobj - dobj) / (one + jnp.abs(dobj))

    p_feas = rho_p <= opts.TolerancePFeas
    d_feas = rho_d <= opts.ToleranceDFeas
    optimal = p_feas & d_feas & (rho_g <= opts.ToleranceRGap)

    # Unbounded-ray (dual infeasibility) certificate (HSD.jl:172-181).
    ray_nrm = jnp.maximum(
        inf_norm(matvec(dat, pt.x)),
        jnp.maximum(inf_norm((pt.x - pt.xl) * dat.lflag),
                    inf_norm((pt.x + pt.xu) * dat.uflag)))
    dual_infeas = (ray_nrm * (norms.c / jnp.maximum(one, norms.b))
                   < -opts.ToleranceIFeas * jnp.dot(dat.c, pt.x))

    # Farkas (primal infeasibility) certificate (HSD.jl:183-193).
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


# ---------------------------------------------------------------------------
# Iteration + drivers
# ---------------------------------------------------------------------------

def init_state(dat: LPData, backend, mehrotra: bool = False) -> HSDState:
    """Cold-start state (reference: HSD.jl:34-65, 238-249).

    ``mehrotra=True`` replaces the all-ones start with the Mehrotra
    least-squares point embedded at τ = κ = 1 (one extra factorization and
    two extra solves, once per solve).
    """
    kkt = backend.setup_data(dat)
    if mehrotra:
        from .mpc import mpc_starting_point
        pt, kkt = mpc_starting_point(dat, backend, kkt)
        one = jnp.ones((), dtype=pt.x.dtype)
        pt = update_mu(pt._replace(kappa=one), dat, hflag=True)
    else:
        pt = starting_point(dat, hflag=True)
    res = compute_residuals(dat, pt)
    dt = pt.x.dtype
    return HSDState(
        pt=pt, res=res,
        regP=jnp.ones(dat.ncol, dtype=dt),
        regD=jnp.ones(dat.nrow, dtype=dt),
        regG=jnp.ones((), dtype=dt),
        kkt=kkt,
        niter=jnp.zeros((), jnp.int32),
        status=jnp.asarray(_UNKNOWN, jnp.int32),
        primal_status=jnp.asarray(_SLN_UNKNOWN, jnp.int32),
        dual_status=jnp.asarray(_SLN_UNKNOWN, jnp.int32),
        pobj=jnp.asarray(jnp.inf, dt),
        dobj=jnp.asarray(-jnp.inf, dt),
    )


def hsd_iteration(backend, opts: HSDOptions, dat: LPData, state: HSDState,
                  ) -> HSDState:
    """Residuals → status checks → (conditionally) one step.

    Matches the reference loop structure where iteration 0 is the starting
    point: residuals and convergence are evaluated before any factorization
    (reference: HSD.jl:251-343).
    """
    norms = _data_norms(dat)
    res = compute_residuals(dat, state.pt)
    pt = update_mu(state.pt, dat, hflag=True)
    state = state._replace(pt=pt, res=res)
    state = update_status(dat, opts, norms, state)
    state = state._replace(status=jnp.where(
        (state.status == _UNKNOWN) & (state.niter >= opts.IterationsLimit),
        jnp.asarray(_ITERATION_LIMIT, jnp.int32), state.status))

    return jax.lax.cond(
        state.status == _UNKNOWN,
        lambda s: compute_step(backend, opts, dat, s),
        lambda s: s,
        state)


@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def _hsd_iteration_jit(backend, opts, dat, state):
    return hsd_iteration(backend, opts, dat, state)




@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def hsd_solve_device(backend, opts: HSDOptions, dat: LPData,
                     state: Optional[HSDState] = None) -> HSDState:
    """Fully-jitted solve: lax.while_loop over iterations. This is the
    building block the batched (vmap) and sharded solvers reuse."""
    if state is None:
        state = init_state(dat, backend, mehrotra=opts.MehrotraStart)

    def cond(s):
        return s.status == _UNKNOWN

    def body(s):
        return hsd_iteration(backend, opts, dat, s)

    return jax.lax.while_loop(cond, body, state)


def hsd_solve(dat: LPData, backend, opts: HSDOptions,
              log_fn=None) -> HSDState:
    """Host-driven solve: one jitted iteration per pass, with logging and
    wall-clock limit between iterations (reference: HSD.jl:203-350).

    When no logging or time limit is requested, defers to the fully-jitted
    while_loop (no host↔device sync per iteration).
    """
    if opts.OutputLevel == 0 and log_fn is None \
            and opts.TimeLimit == float("inf"):
        # init_state runs eagerly: backends with host-side symbolic analysis
        # (e.g. the banded RCM plan) must see concrete arrays in setup.
        state0 = full_matmul_precision(init_state)(
            dat, backend, mehrotra=opts.MehrotraStart)
        return jax.block_until_ready(
            hsd_solve_device(backend, opts, dat, state0))

    state = full_matmul_precision(init_state)(
        dat, backend, mehrotra=opts.MehrotraStart)
    tstart = time.time()
    if opts.OutputLevel > 0:
        print("\nOptimizer info (HSD)")
        print(f"Constraints  : {dat.nrow}")
        print(f"Variables    : {dat.ncol}")
        # Linear-solver introspection (reference: src/IPM/HSD/HSD.jl:214-230
        # via KKT.arithmetic/backend/linear_system, src/KKT/KKT.jl:103-121).
        print("Linear solver:")
        print(f"  Arithmetic : {backend.arithmetic_label(dat.c.dtype)}")
        print(f"  Backend    : {backend.name}")
        print(f"  System     : {backend.linear_system()}")
        print(f"\n{'Itn':>4}  {'PObj':>14}  {'DObj':>14}  "
              f"{'PFeas':>8} {'DFeas':>8} {'GFeas':>8}  {'Mu':>7}  Time")

    def log_row(k, s, ttot):
        print(f"{k:4d}  {float(s.pobj):+14.7e}  "
              f"{float(s.dobj):+14.7e}  "
              f"{float(jnp.maximum(s.res.rp_nrm, s.res.ru_nrm)):8.2e} "
              f"{float(s.res.rd_nrm):8.2e} "
              f"{float(s.res.rg_nrm):8.2e}  "
              f"{float(s.pt.mu):7.1e}  {ttot:.2f}")

    prev_niter = -1
    while True:
        # Each jitted pass computes residuals/objectives at the CURRENT
        # point, then (if not terminal) steps and increments niter — so the
        # logged residual row belongs to the entry iteration count
        # (row k = point k, matching the reference's log,
        # reference: HSD.jl:252-287).
        n_entry = int(state.niter)
        state = jax.block_until_ready(
            _hsd_iteration_jit(backend, opts, dat, state))
        ttot = time.time() - tstart
        if opts.OutputLevel > 0:
            log_row(n_entry, state, ttot)
        if log_fn is not None:
            log_fn(state)
        if int(state.status) != _UNKNOWN:
            break
        if int(state.niter) == prev_niter:
            # No progress is only possible when a terminal status was set.
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

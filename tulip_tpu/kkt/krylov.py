"""Matrix-free Krylov KKT backends.

Counterpart of the reference's TlpKrylov module
(reference: src/KKT/Krylov/{krylov,defs,spd,sid}.jl): instead of a
factorization, ``update`` only refreshes the diagonals, and ``solve`` runs an
iterative method against an implicit operator. The operator
application is two GEMVs, and everything sits inside
``lax.while_loop`` — no host round-trips per Krylov iteration.

- ``CgK1Backend``: conjugate gradients on the SPD normal-equations operator
  ``w ↦ A D Aᵀ w + Rd w`` with Jacobi preconditioning
  (reference operator shape: src/KKT/Krylov/spd.jl:55-63).
- ``MinresK2Backend``: MINRES on the full symmetric indefinite augmented
  operator over (dx, dy) (reference: src/KKT/Krylov/sid.jl:50-64).
- ``TricgK2Backend``: the reference's SQD family (TriCG,
  reference: src/KKT/Krylov/sqd.jl:87-92) — exploits the symmetric
  quasi-definite 2x2 block form with the natural diagonal preconditioners
  M = Rd, N = Θ⁻¹+Rp via the Saunders-Simon-Yip tridiagonalization
  (Montoison & Orban, SIAM J. Sci. Comput. 2021). Experimental for full
  IPM runs: once Θ spans ~16 orders of magnitude near convergence the
  short recurrences lose orthogonality and the unweighted dual residual
  degrades (the N⁻¹-weighted Galerkin residual it controls stays small) —
  prefer ``sqd-minres`` end-to-end, matching the reference's own framing
  of its Krylov backends as research options.
- ``SqdMinresK2Backend``: minimum-residual counterpart (the TriMR role):
  MINRES on the SQD system symmetrically scaled by diag(M,N)^(-1/2), i.e.
  block-Jacobi-preconditioned MINRES.

Tolerances default to sqrt(eps) like the reference (spd.jl:66-67).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import KKTBackend


class KrylovState(NamedTuple):
    A: jnp.ndarray          # (m, n)
    d: jnp.ndarray          # (n,)  D = (Θ⁻¹ + Rp)⁻¹
    theta_reg: jnp.ndarray  # (n,)  Θ⁻¹ + Rp
    regD: jnp.ndarray       # (m,)


def _sqrt_eps(dt) -> float:
    return float(np.sqrt(np.finfo(np.dtype(dt.name)).eps))


def minres(matvec: Callable, b: jnp.ndarray, rtol, maxiter: int,
           ) -> jnp.ndarray:
    """MINRES (Paige & Saunders 1975) for symmetric (possibly indefinite)
    systems, as a single ``lax.while_loop``."""
    dt = b.dtype
    zero = jnp.zeros((), dt)
    one = jnp.ones((), dt)

    beta1 = jnp.linalg.norm(b)
    beta1_safe = jnp.where(beta1 == 0, one, beta1)

    # carry: (x, v_prev, v, beta, eta, gamma0, gamma1, sigma0, sigma1,
    #         w_mm, w_m, k, rnorm)
    x0 = jnp.zeros_like(b)
    v0 = b / beta1_safe
    carry0 = (x0, jnp.zeros_like(b), v0, beta1, beta1, one, one, zero, zero,
              jnp.zeros_like(b), jnp.zeros_like(b), jnp.zeros((), jnp.int32),
              beta1)

    tol = rtol * beta1_safe

    def cond(c):
        *_, k, rnorm = c
        return (rnorm > tol) & (k < maxiter)

    def body(c):
        (x, v_prev, v, beta, eta, g0, g1, s0, s1, w_mm, w_m, k, _) = c
        Av = matvec(v)
        alpha = jnp.dot(v, Av)
        r = Av - alpha * v - beta * v_prev
        beta_next = jnp.linalg.norm(r)
        beta_next_safe = jnp.where(beta_next == 0, one, beta_next)
        v_next = r / beta_next_safe

        delta = g1 * alpha - g0 * s1 * beta
        rho1 = jnp.sqrt(delta * delta + beta_next * beta_next)
        rho1_safe = jnp.where(rho1 == 0, one, rho1)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        g_next = delta / rho1_safe
        s_next = beta_next / rho1_safe

        w = (v - rho3 * w_mm - rho2 * w_m) / rho1_safe
        x = x + g_next * eta * w
        eta_next = -s_next * eta
        rnorm = jnp.abs(eta_next)
        return (x, v, v_next, beta_next, eta_next, g1, g_next, s1, s_next,
                w_m, w, k + 1, rnorm)

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0]


def pcg(matvec: Callable, b: jnp.ndarray, precond: Callable, rtol,
        maxiter: int) -> jnp.ndarray:
    """Preconditioned conjugate gradients as a single ``lax.while_loop``."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    gamma0 = jnp.dot(r0, z0)
    bnorm = jnp.linalg.norm(b)
    tol2 = (rtol * jnp.where(bnorm == 0, 1.0, bnorm)) ** 2

    def cond(c):
        x, r, z, p, gamma, k = c
        return (jnp.dot(r, r) > tol2) & (k < maxiter)

    def body(c):
        x, r, z, p, gamma, k = c
        Ap = matvec(p)
        denom = jnp.dot(p, Ap)
        alpha = gamma / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = jnp.dot(r, z)
        beta = gamma_new / jnp.where(gamma == 0, 1.0, gamma)
        p = z + beta * p
        return x, r, z, p, gamma_new, k + 1

    out = jax.lax.while_loop(cond, body,
                             (x0, r0, z0, z0, gamma0,
                              jnp.zeros((), jnp.int32)))
    return out[0]


def cr(matvec: Callable, b: jnp.ndarray, precond: Callable, rtol,
       maxiter: int) -> jnp.ndarray:
    """Preconditioned conjugate residuals (SPD; minimizes ||r|| instead of
    the A-norm error — the reference's SPD family also exposes CR,
    reference: src/KKT/Krylov/defs.jl:1-17)."""
    x0 = jnp.zeros_like(b)
    z0 = precond(b)              # preconditioned residual M⁻¹r
    p0 = z0
    Az0 = matvec(z0)
    Ap0 = Az0
    gamma0 = jnp.dot(z0, Az0)
    bnorm = jnp.linalg.norm(b)
    tol2 = (rtol * jnp.where(bnorm == 0, 1.0, bnorm)) ** 2

    # The TRUE residual r = b − Kx is carried alongside z: testing
    # ‖M⁻¹r‖ against rtol·‖b‖ stops orders of magnitude too early when
    # the Jacobi diagonal is large (late-IPM Θ⁻¹ ~ 1e16), which returned
    # junk steps and stalled the IPM at ITERATION_LIMIT (round-5 finding;
    # this is exactly the failure class the end-to-end Krylov goldens
    # exist to catch).
    def cond(c):
        x, r, z, p, Az, Ap, gamma, k = c
        return (jnp.dot(r, r) > tol2) & (k < maxiter)

    def body(c):
        x, r, z, p, Az, Ap, gamma, k = c
        MAp = precond(Ap)
        denom = jnp.dot(Ap, MAp)
        alpha = gamma / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = z - alpha * MAp
        Az = matvec(z)
        gamma_new = jnp.dot(z, Az)
        beta = gamma_new / jnp.where(gamma == 0, 1.0, gamma)
        p = z + beta * p
        Ap = Az + beta * Ap
        return x, r, z, p, Az, Ap, gamma_new, k + 1

    out = jax.lax.while_loop(cond, body,
                             (x0, b, z0, p0, Az0, Ap0, gamma0,
                              jnp.zeros((), jnp.int32)))
    return out[0]


def car(matvec: Callable, b: jnp.ndarray, precond: Callable, rtol,
        maxiter: int) -> jnp.ndarray:
    """CAR — conjugate A-residuals for SPD systems (the third member of the
    reference's SPD family, reference: src/KKT/Krylov/defs.jl:1-5;
    Montoison, Orban & Saunders 2023). Minimizes ``||r_k||_A`` over the
    Krylov space, one operator application per iteration.

    Orthomin-form recurrences with A³-conjugate directions: maintaining
    q = Ar, u = Ap, w = A²p,

        α = rᵀA²r / pᵀA³p = <q,q> / <u,w>,
        x += αp,  r -= αu,  q -= αw,  s = Aq,
        β = <q',q'> / <q,q>,
        p = r + βp,  u = q + βu,  w = s + βw.

    Preconditioning is symmetric-diagonal: callers pass the Jacobi-scaled
    operator (precond here only shapes the initial q/s like in cr)."""
    del precond  # symmetric scaling is applied by the caller
    x0 = jnp.zeros_like(b)
    r0 = b
    q0 = matvec(r0)
    s0 = matvec(q0)
    rho0 = jnp.dot(q0, q0)
    bnorm = jnp.linalg.norm(b)
    tol2 = (rtol * jnp.where(bnorm == 0, 1.0, bnorm)) ** 2

    def cond(c):
        x, r, q, p, u, w, rho, k = c
        return (jnp.dot(r, r) > tol2) & (k < maxiter)

    def body(c):
        x, r, q, p, u, w, rho, k = c
        denom = jnp.dot(u, w)
        alpha = rho / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * u
        q = q - alpha * w
        s = matvec(q)
        rho_new = jnp.dot(q, q)
        beta = rho_new / jnp.where(rho == 0, 1.0, rho)
        p = r + beta * p
        u = q + beta * u
        w = s + beta * w
        return x, r, q, p, u, w, rho_new, k + 1

    out = jax.lax.while_loop(cond, body,
                             (x0, r0, q0, r0, q0, s0, rho0,
                              jnp.zeros((), jnp.int32)))
    return out[0]


def _sym_givens(a, b):
    """Symmetric orthogonal reflection: returns (c, s, r) with
    [c s; s -c][a; b] = [r; 0], r = hypot(a, b) >= 0."""
    r = jnp.sqrt(a * a + b * b)
    r_safe = jnp.where(r == 0, 1.0, r)
    c = jnp.where(r == 0, 1.0, a / r_safe)
    s = jnp.where(r == 0, 0.0, b / r_safe)
    return c, s, r


def minres_qlp(matvec: Callable, b: jnp.ndarray, rtol, maxiter: int,
               ) -> jnp.ndarray:
    """MINRES-QLP (Choi, Paige & Saunders, SIAM J. Sci. Comput. 2011) for
    symmetric (possibly indefinite or singular) systems, as one
    ``lax.while_loop``.

    Beyond MINRES it applies a second, right-side sequence of reflections
    (the QLP decomposition of the tridiagonal), which keeps the solution
    update well-conditioned near (numerical) singularity and converges to
    the minimum-length solution of singular consistent systems. This runs
    the always-QLP variant (the MINRES-mode fast path of the reference
    implementation is a speed optimization only)."""
    dt = b.dtype
    zero = jnp.zeros((), dt)
    one = jnp.ones((), dt)

    beta1 = jnp.linalg.norm(b)
    beta1_safe = jnp.where(beta1 == 0, one, beta1)
    tol = rtol * beta1_safe

    n_x = jnp.zeros_like(b)
    # carry layout — Lanczos: r1, r2 (scaled v's), beta, betan;
    # left reflections: cs, sn, dltan, eplnn; right-rotated tridiagonal
    # entries gama/gamal (provisional diagonals of rows k, k-1), eta/etal,
    # vepln/veplnl; solution: tau/taul, phi, ul3/ul2/ul/u, xl2, wl, w; k.
    # Both right reflections (P_{k-2,k} and P_{k-1,k}) are computed fresh
    # every iteration — each W/L column receives four rotations in total
    # (two at creation, one at each of the next two iterations), so row
    # k-2 and W column k-2 finalize at iteration k.
    carry0 = dict(
        r1=jnp.zeros_like(b), r2=b, beta=zero, betan=beta1,
        cs=-one, sn=zero, dltan=zero, eplnn=zero,
        gama=zero, gamal=zero,
        eta=zero, etal=zero, vepln=zero, veplnl=zero,
        tau=zero, taul=zero, phi=beta1,
        ul3=zero, ul2=zero, ul=zero, u=zero,
        xl2=n_x, wl=jnp.zeros_like(b), w=jnp.zeros_like(b),
        x=n_x, k=jnp.zeros((), jnp.int32),
    )

    def cond(c):
        return (c["phi"] > tol) & (c["k"] < maxiter)

    def body(c):
        k = c["k"] + 1
        # -- Lanczos step (r1/r2 carry beta-scaled basis vectors) --
        betal = c["beta"]
        beta = c["betan"]
        beta_safe = jnp.where(beta == 0, one, beta)
        v = c["r2"] / beta_safe
        r3 = matvec(v)
        r3 = jnp.where(k > 1, r3 - (beta / jnp.where(betal == 0, one, betal))
                       * c["r1"], r3)
        alfa = jnp.dot(v, r3)
        r3 = r3 - (alfa / beta_safe) * c["r2"]
        betan = jnp.linalg.norm(r3)

        # -- previous left reflection Q_{k-1} --
        dbar = c["dltan"]
        dlta = c["cs"] * dbar + c["sn"] * alfa
        epln = c["eplnn"]
        gbar = c["sn"] * dbar - c["cs"] * alfa
        eplnn = c["sn"] * betan
        dltan = -c["cs"] * betan
        # -- current left reflection Q_k --
        gamal2 = c["gamal"]
        gamal = c["gama"]
        cs, sn, gama = _sym_givens(gbar, betan)
        taul2 = c["taul"]
        taul = c["tau"]
        tau = cs * c["phi"]
        phi = sn * c["phi"]

        # -- first right reflection P_{k-2,k}: zeros the (k-2, k) entry
        # epln against the provisional row-(k-2) diagonal, finalizing it --
        k_gt2 = k > 2
        etal2 = c["etal"]          # final eta_{k-2} (set at iteration k-2)
        veplnl2 = c["veplnl"]      # final nu_{k-2}  (set at iteration k-1)
        cr2_n, sr2_n, gamal2_rot = _sym_givens(gamal2, epln)
        cr2 = jnp.where(k_gt2, cr2_n, -one)
        sr2 = jnp.where(k_gt2, sr2_n, zero)
        gamal2 = jnp.where(k_gt2, gamal2_rot, gamal2)
        veplnl = jnp.where(k_gt2, cr2 * c["vepln"] + sr2 * dlta,
                           c["veplnl"])
        dlta = jnp.where(k_gt2, sr2 * c["vepln"] - cr2 * dlta, dlta)
        etal = jnp.where(k_gt2, c["eta"], c["etal"])
        eta = jnp.where(k_gt2, sr2 * gama, zero)
        gama = jnp.where(k_gt2, -cr2 * gama, gama)
        # -- second right reflection P_{k-1,k}: zeros the rotated (k-1, k)
        # entry against the provisional row-(k-1) diagonal --
        k_gt1 = k > 1
        cr1_n, sr1_n, gamal_rot = _sym_givens(gamal, dlta)
        cr1 = jnp.where(k_gt1, cr1_n, -one)
        sr1 = jnp.where(k_gt1, sr1_n, zero)
        gamal = jnp.where(k_gt1, gamal_rot, gamal)
        vepln = jnp.where(k_gt1, sr1 * gama, c["vepln"])
        gama = jnp.where(k_gt1, -cr1 * gama, gama)

        # -- solution coefficients (forward substitution through L) --
        # Row k-2 is final this iteration; rows k-1 and k stay provisional.
        ul4 = c["ul3"]
        ul3 = c["ul2"]
        ul2 = jnp.where(
            k_gt2,
            (taul2 - etal2 * ul4 - veplnl2 * ul3)
            / jnp.where(gamal2 == 0, one, gamal2),
            c["ul2"])
        ul = jnp.where(
            k_gt1,
            (taul - etal * ul3 - veplnl * ul2)
            / jnp.where(gamal == 0, one, gamal),
            c["ul"])
        gama_safe = jnp.where(gama == 0, one, gama)
        u = jnp.where(jnp.abs(gama) > 0,
                      (tau - eta * ul2 - vepln * ul) / gama_safe, zero)

        # -- QLP direction vectors and iterate --
        wl2 = c["wl"]
        wl_1 = v * sr1                       # k == 1
        w_1 = -v * cr1
        wl_2 = c["w"] * cr1 + v * sr1        # k == 2
        w_2 = c["w"] * sr1 - v * cr1
        # k >= 3
        wl_3a = c["w"]
        w_3a = wl2 * sr2 - v * cr2
        wl2_3 = wl2 * cr2 + v * sr2
        v_3 = wl_3a * cr1 + w_3a * sr1
        w_3 = wl_3a * sr1 - w_3a * cr1
        wl_3 = v_3

        wl2_out = jnp.where(k_gt2, wl2_3, wl2)
        wl_out = jnp.where(k == 1, wl_1, jnp.where(k == 2, wl_2, wl_3))
        w_out = jnp.where(k == 1, w_1, jnp.where(k == 2, w_2, w_3))

        xl2 = c["xl2"] + wl2_out * ul2
        x = xl2 + wl_out * ul + w_out * u

        return dict(
            r1=c["r2"], r2=r3, beta=beta, betan=betan,
            cs=cs, sn=sn, dltan=dltan, eplnn=eplnn,
            gama=gama, gamal=gamal,
            eta=eta, etal=etal, vepln=vepln, veplnl=veplnl,
            tau=tau, taul=taul, phi=phi,
            ul3=ul3, ul2=ul2, ul=ul, u=u,
            xl2=xl2, wl=wl_out, w=w_out,
            x=x, k=k,
        )

    out = jax.lax.while_loop(cond, body, carry0)
    return out["x"]


def symmlq(matvec: Callable, b: jnp.ndarray, rtol, maxiter: int,
           ) -> jnp.ndarray:
    """SYMMLQ (Paige & Saunders 1975) for symmetric (possibly indefinite)
    systems, as one ``lax.while_loop``.

    Derivation used here: with Lanczos ``A V_k = V_{k+1} T̄_k``, the
    Galerkin condition for x = V_{k+1} y reads ``T̄_kᵀ y = β₁ e₁``
    (underdetermined); SYMMLQ takes the minimum-norm y via an LQ
    factorization of T̄ᵀ built from symmetric reflection rotations
    G_i = [[c, s], [s, -c]] on columns (i, i+1):

        ε_k = s_{k-2} β_k,   δ_k = -c_{k-1} c_{k-2} β_k + s_{k-1} α_k,
        γ̄_k = -s_{k-1} c_{k-2} β_k - c_{k-1} α_k,
        γ_k = hypot(γ̄_k, β_{k+1}),  c_k = γ̄_k/γ_k,  s_k = β_{k+1}/γ_k

    forward solve L z = β₁ e₁ and direction columns W = V Qᵀ via
    ``w_k = c_k w̄_k + s_k v_{k+1}``, ``w̄_{k+1} = s_k w̄_k - c_k v_{k+1}``.
    Stopping uses the true residual (one extra matvec per iteration —
    SYMMLQ here is a conformance/fallback method; MINRES is the
    production SID solver)."""
    dt = b.dtype
    one = jnp.ones((), dt)

    def safe(x):
        return jnp.where(x == 0, one, x)

    beta1 = jnp.linalg.norm(b)
    v1 = b / safe(beta1)
    # First Lanczos step.
    u = matvec(v1)
    alpha1 = jnp.dot(v1, u)
    u = u - alpha1 * v1
    beta2 = jnp.linalg.norm(u)
    v2 = u / safe(beta2)
    tol = rtol * safe(beta1)

    # carry: x, v_k, v_{k+1}, α_k, β_k, β_{k+1}, c_{k-2}, s_{k-2},
    #        c_{k-1}, s_{k-1}, z_{k-2}, z_{k-1}, h (forward-solve RHS:
    #        β₁ at k=1, then 0), w̄_k, k, rnorm.  c₀ = -1, s₀ = 0 make the
    #        k=1,2 edge rows come out of the general recurrences.
    carry0 = (jnp.zeros_like(b), v1, v2, alpha1, jnp.zeros((), dt), beta2,
              -one, jnp.zeros((), dt), -one, jnp.zeros((), dt),
              jnp.zeros((), dt), jnp.zeros((), dt), beta1, v1,
              jnp.zeros((), jnp.int32), beta1)

    def cond(c):
        *_, k, rnorm = c
        return (rnorm > tol) & (k < maxiter)

    def body(c):
        (x, vk, vk1, alpha, beta_k, beta_n, c2, s2, c1, s1, z2, z1, h,
         wbar, k, _) = c
        eps_k = s2 * beta_k
        delta_k = -c1 * c2 * beta_k + s1 * alpha
        gbar_k = -s1 * c2 * beta_k - c1 * alpha
        gamma_k = jnp.sqrt(gbar_k ** 2 + beta_n ** 2)
        ck = gbar_k / safe(gamma_k)
        sk = beta_n / safe(gamma_k)
        # Forward solve: z_k = (h - ε_k z_{k-2} - δ_k z_{k-1}) / γ_k with
        # h = β₁ for k=1 and 0 after.
        zk = (h - eps_k * z2 - delta_k * z1) / safe(gamma_k)
        # Direction and iterate.
        wk = ck * wbar + sk * vk1
        wbar_next = sk * wbar - ck * vk1
        x = x + zk * wk
        # Next Lanczos step (α_{k+1}, β_{k+2}, v_{k+2}).
        u = matvec(vk1) - beta_n * vk
        alpha_next = jnp.dot(vk1, u)
        u = u - alpha_next * vk1
        beta_nn = jnp.linalg.norm(u)
        v_next = u / safe(beta_nn)
        # True residual for stopping (extra matvec).
        rnorm = jnp.linalg.norm(b - matvec(x))
        return (x, vk1, v_next, alpha_next, beta_n, beta_nn, c1, s1,
                ck, sk, z1, zk, jnp.zeros((), dt), wbar_next, k + 1, rnorm)

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0]


def tricg(A, Mdiag, Ndiag, b, c, rtol, maxiter):
    """TriCG: Galerkin method for the symmetric quasi-definite system

        [ M   A ] [x]   [b]
        [ Aᵀ  -N ] [y] = [c]

    with diagonal SPD M (m) and N (n), via the preconditioned
    Saunders-Simon-Yip process. Bases V (M-orthonormal) and U
    (N-orthonormal) satisfy ``A U_k = M V_k T_k + β_{k+1} M v_{k+1} e_kᵀ``
    and ``Aᵀ V_k = N U_k T_kᵀ + γ_{k+1} N u_{k+1} e_kᵀ``; the Galerkin
    conditions reduce to the 2k×2k SQD block-tridiagonal system
    ``[I T; Tᵀ -I]`` solved incrementally by block-LDLᵀ with 2×2 pivots
    (strongly factorizable — Vanderbei). O(m+n) storage per iteration.
    """
    dt = b.dtype
    one = jnp.ones((), dt)
    Minv = 1.0 / Mdiag
    Ninv = 1.0 / Ndiag

    def safe(s):
        return jnp.where(s == 0, one, s)

    beta1 = jnp.sqrt(jnp.dot(b, Minv * b))
    gamma1 = jnp.sqrt(jnp.dot(c, Ninv * c))
    v1 = (Minv * b) / safe(beta1)
    u1 = (Ninv * c) / safe(gamma1)
    tol = rtol * jnp.sqrt(beta1 ** 2 + gamma1 ** 2)
    h1 = jnp.stack([beta1, gamma1])

    m, n = A.shape
    z2 = jnp.zeros((2, 2), dt)
    carry0 = (
        jnp.zeros(m, dt), jnp.zeros(n, dt),        # x, y
        jnp.zeros(m, dt), v1,                       # v_prev, v
        jnp.zeros(n, dt), u1,                       # u_prev, u
        beta1, gamma1,                              # β_k, γ_k
        z2, jnp.zeros(2, dt),                       # Δ_{k-1}⁻¹, ζ_{k-1}
        jnp.zeros(m, dt), jnp.zeros(n, dt),         # G col1 (v-part, u-part)
        jnp.zeros(m, dt), jnp.zeros(n, dt),         # G col2
        jnp.zeros((), jnp.int32),
        jnp.sqrt(beta1 ** 2 + gamma1 ** 2),         # rnorm estimate
    )

    def cond(cr_):
        *_, k, rnorm = cr_
        return (rnorm > tol) & (k < maxiter)

    def body(cr_):
        (x, y, v_prev, v, u_prev, u, beta, gamma, Dinv_prev, zeta_prev,
         g1v, g1u, g2v, g2u, k, _) = cr_
        Au = A @ u
        Atv = A.T @ v
        alpha = jnp.dot(v, Au)
        q = Minv * Au - gamma * v_prev - alpha * v
        p = Ninv * Atv - beta * u_prev - alpha * u
        beta_n = jnp.sqrt(jnp.dot(q, Mdiag * q))
        gamma_n = jnp.sqrt(jnp.dot(p, Ndiag * p))
        # Breakdown deflation: when one Krylov space is exhausted the new
        # norm is pure rounding noise; normalizing it would inject a junk
        # basis vector and break the three-term recurrences. Zero the
        # vector instead (the process then keeps expanding the other
        # space, which is the exact-arithmetic behavior).
        eps_b = jnp.asarray(np.finfo(np.dtype(dt.name)).eps ** 0.75, dt)
        scale_q = jnp.sqrt(jnp.dot(Au, Minv * Au)) + gamma + jnp.abs(alpha)
        scale_p = jnp.sqrt(jnp.dot(Atv, Ninv * Atv)) + beta + jnp.abs(alpha)
        dead_v = beta_n <= eps_b * scale_q
        dead_u = gamma_n <= eps_b * scale_p
        beta_n = jnp.where(dead_v, 0.0, beta_n)
        gamma_n = jnp.where(dead_u, 0.0, gamma_n)
        v_next = jnp.where(dead_v, 0.0, q / safe(beta_n))
        u_next = jnp.where(dead_u, 0.0, p / safe(gamma_n))

        # Block-LDLᵀ step on [I T; Tᵀ -I] in interleaved (x̄_i, ȳ_i) order:
        # diag blocks Ω_i=[1 α_i; α_i -1], coupling Ψ_{i-1}=[0 γ_i; β_i 0].
        psi = jnp.array([[0.0, 0.0], [0.0, 0.0]], dt)
        psi = psi.at[0, 1].set(gamma).at[1, 0].set(beta)
        lam = psi.T @ Dinv_prev                 # Λ_k = Ψ_{k-1}ᵀ Δ_{k-1}⁻¹
        omega = jnp.array([[0.0, 0.0], [0.0, 0.0]], dt)
        omega = omega.at[0, 0].set(1.0).at[0, 1].set(alpha) \
                     .at[1, 0].set(alpha).at[1, 1].set(-1.0)
        delta = omega - lam @ psi
        det = delta[0, 0] * delta[1, 1] - delta[0, 1] * delta[1, 0]
        dinv = jnp.array([[0.0, 0.0], [0.0, 0.0]], dt)
        dinv = dinv.at[0, 0].set(delta[1, 1]).at[0, 1].set(-delta[0, 1]) \
                   .at[1, 0].set(-delta[1, 0]).at[1, 1].set(delta[0, 0])
        dinv = dinv / safe(det)
        h = jnp.where(k == 0, h1, jnp.zeros(2, dt))
        zeta = h - lam @ zeta_prev
        # Direction blocks G_k = P_k - G_{k-1} Λ_kᵀ with P_k = [v 0; 0 u].
        g1v_n = v - (g1v * lam[0, 0] + g2v * lam[0, 1])
        g1u_n = -(g1u * lam[0, 0] + g2u * lam[0, 1])
        g2v_n = -(g1v * lam[1, 0] + g2v * lam[1, 1])
        g2u_n = u - (g1u * lam[1, 0] + g2u * lam[1, 1])
        t = dinv @ zeta                          # last block of w̄
        x = x + t[0] * g1v_n + t[1] * g2v_n
        y = y + t[0] * g1u_n + t[1] * g2u_n
        # Residual lies in span{Mv_{k+1}, Nu_{k+1}}:
        # ‖r‖ over diag(M⁻¹,N⁻¹) = hypot(β_{k+1}·ȳ_k, γ_{k+1}·x̄_k).
        rnorm = jnp.sqrt((beta_n * t[1]) ** 2 + (gamma_n * t[0]) ** 2)
        return (x, y, v, v_next, u, u_next, beta_n, gamma_n, dinv, zeta,
                g1v_n, g1u_n, g2v_n, g2u_n, k + 1, rnorm)

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0], out[1]


@dataclasses.dataclass(frozen=True)
class CgK1Backend(KKTBackend):
    name = "cg"
    systems = ("K1",)
    # Matrix-free: satisfies the Jacobi-weighted residual criterion, not
    # the kit's uniform relative gate; validated end-to-end at measured
    # achievable tolerances (tests/test_krylov_golden.py).
    sweep_resid_atol = None
    rtol: float = 0.0        # 0 -> sqrt(eps(dtype))
    maxiter_factor: int = 10  # maxiter = factor * m

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Normal equations (K1), CG"

    def setup(self, A: jnp.ndarray) -> KrylovState:
        m, n = A.shape
        dt = A.dtype
        return KrylovState(A=A, d=jnp.ones(n, dt), theta_reg=jnp.ones(n, dt),
                           regD=jnp.ones(m, dt))

    def update(self, state: KrylovState, theta_inv, regP, regD):
        theta_reg = theta_inv + regP
        new = KrylovState(A=state.A, d=1.0 / theta_reg, theta_reg=theta_reg,
                          regD=regD)
        ok = jnp.all(theta_reg > 0) & jnp.all(regD > 0)
        return new, ok

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[0]

        def K_mv(w):
            return A @ (d * (A.T @ w)) + regD * w

        # Jacobi preconditioner: diag(A D Aᵀ) + Rd.
        Kdiag = (A * A) @ d + regD
        rhs = xi_p + A @ (d * xi_d)
        dy = pcg(K_mv, rhs, lambda r: r / Kdiag, rtol, maxiter)
        dx = d * (A.T @ dy - xi_d)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class CrK1Backend(CgK1Backend):
    """Conjugate residuals on the K1 normal equations."""

    name = "cr"

    def linear_system(self) -> str:
        return "Normal equations (K1), CR"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[0]

        def K_mv(w):
            return A @ (d * (A.T @ w)) + regD * w

        Kdiag = (A * A) @ d + regD
        rhs = xi_p + A @ (d * xi_d)
        dy = cr(K_mv, rhs, lambda r: r / Kdiag, rtol, maxiter)
        dx = d * (A.T @ dy - xi_d)
        return dx, dy


@dataclasses.dataclass(frozen=True)
class MinresK2Backend(KKTBackend):
    """Unpreconditioned MINRES on the raw K2 augmented system (reference
    parity: the reference's SID Krylov solvers are also unpreconditioned,
    src/KKT/Krylov/sid.jl:50-64). Achievable end-to-end tolerance is
    ~1e-6 (golden-LP measurement): late-IPM K2 carries Θ⁻¹ entries up to
    ~1e16 and the unscaled residual test cannot deliver accurate dx
    components past that. For full 1e-8 use "sqd-minres" (the same
    method under the natural SQD diagonal scaling) or "minres-qlp"."""

    name = "minres"
    systems = ("K2",)
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    rtol: float = 0.0
    maxiter_factor: int = 10

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Augmented system (K2), MINRES"

    def setup(self, A: jnp.ndarray) -> KrylovState:
        m, n = A.shape
        dt = A.dtype
        return KrylovState(A=A, d=jnp.ones(n, dt), theta_reg=jnp.ones(n, dt),
                           regD=jnp.ones(m, dt))

    update = CgK1Backend.update

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)

        def K2_mv(w):
            wx, wy = w[:n], w[n:]
            top = -theta_reg * wx + A.T @ wy
            bot = A @ wx + regD * wy
            return jnp.concatenate([top, bot])

        rhs = jnp.concatenate([xi_d, xi_p])
        sol = minres(K2_mv, rhs, rtol, maxiter)
        return sol[:n], sol[n:]

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class TricgK2Backend(KKTBackend):
    """TriCG on the SQD augmented system (the reference's TriCG/TriMR
    family, reference: src/KKT/Krylov/sqd.jl:87-92). The K2 system

        [-(Θ⁻¹+Rp)  Aᵀ] [dx]   [ξd]
        [    A      Rd] [dy] = [ξp]

    reordered as [Rd A; Aᵀ -(Θ⁻¹+Rp)][dy; dx] = [ξp; ξd] is exactly the
    TriCG form with M = Rd, N = Θ⁻¹+Rp — the same natural diagonal
    preconditioners the reference passes to Krylov.jl (sqd.jl:90-91)."""

    name = "tricg"
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    systems = ("K2",)
    rtol: float = 0.0
    maxiter_factor: int = 10
    # Experimental (see module docstring): controls the N⁻¹-weighted
    # residual, but the unweighted dual residual degrades at late-IPM Θ
    # spans; prefer sqd-minres for full solves.
    experimental = True

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Augmented system (K2), TriCG"

    setup = MinresK2Backend.setup
    update = CgK1Backend.update

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * sum(A.shape)
        dy, dx = tricg(A, regD, theta_reg, xi_p, xi_d, rtol, maxiter)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class SqdMinresK2Backend(MinresK2Backend):
    """Minimum-residual method on the SQD augmented system with the natural
    block-Jacobi preconditioner (the TriMR role of the reference's SQD
    family): symmetrically scale K2 by diag(Θ⁻¹+Rp, Rd)^(-1/2) so the
    scaled operator is [-I Â; Âᵀ I], then run MINRES and unscale."""

    name = "sqd-minres"

    def linear_system(self) -> str:
        return "Augmented system (K2), SQD-scaled MINRES"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)
        f = jnp.sqrt(theta_reg)          # F = (Θ⁻¹+Rp)^(1/2)
        e = jnp.sqrt(regD)               # E = Rd^(1/2)

        def K2_mv(w):
            wx, wy = w[:n], w[n:]
            top = -wx + (A.T @ (wy / e)) / f
            bot = (A @ (wx / f)) / e + wy
            return jnp.concatenate([top, bot])

        rhs = jnp.concatenate([xi_d / f, xi_p / e])
        sol = minres(K2_mv, rhs, rtol, maxiter)
        return sol[:n] / f, sol[n:] / e


@dataclasses.dataclass(frozen=True)
class SymmlqK2Backend(MinresK2Backend):
    """SYMMLQ on the augmented system (the reference's SID family also
    exposes SYMMLQ, reference: src/KKT/Krylov/defs.jl:9-17). Galerkin
    (minimum-error) counterpart of MINRES; kept as a conformance/fallback
    option — it spends one extra operator application per iteration on
    true-residual stopping. Achievable end-to-end tolerance ~1e-4
    (golden-LP measurement; Galerkin iterates lose accuracy on the
    unscaled late-IPM K2 faster than MINRES's residual-optimal ones)."""

    name = "symmlq"

    def linear_system(self) -> str:
        return "Augmented system (K2), SYMMLQ"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)

        def K2_mv(w):
            wx, wy = w[:n], w[n:]
            top = -theta_reg * wx + A.T @ wy
            bot = A @ wx + regD * wy
            return jnp.concatenate([top, bot])

        rhs = jnp.concatenate([xi_d, xi_p])
        sol = symmlq(K2_mv, rhs, rtol, maxiter)
        return sol[:n], sol[n:]


@dataclasses.dataclass(frozen=True)
class CarK1Backend(CgK1Backend):
    """CAR on the K1 normal equations (reference SPD family:
    src/KKT/Krylov/defs.jl:1-5). Minimizes the K-norm of the residual;
    Jacobi preconditioning applied as a symmetric diagonal scaling so the
    scaled operator stays SPD."""

    name = "car"

    def linear_system(self) -> str:
        return "Normal equations (K1), CAR"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, d, regD = state.A, state.d, state.regD
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * A.shape[0]

        # Symmetric Jacobi scaling: solve S K S (S⁻¹dy) = S rhs with
        # S = diag(K)^(-1/2), keeping the operator SPD for CAR.
        Kdiag = (A * A) @ d + regD
        s = 1.0 / jnp.sqrt(Kdiag)

        def K_mv(w):
            return s * (A @ (d * (A.T @ (s * w)))) + s * regD * (s * w)

        rhs = s * (xi_p + A @ (d * xi_d))
        dy = s * car(K_mv, rhs, None, rtol, maxiter)
        dx = d * (A.T @ dy - xi_d)
        return dx, dy


@dataclasses.dataclass(frozen=True)
class MinresQlpK2Backend(MinresK2Backend):
    """MINRES-QLP on the augmented system (reference SID family:
    src/KKT/Krylov/defs.jl:9-17). Extra right-side QLP reflections keep
    the iterate update well-conditioned when the (regularized) system
    approaches numerical singularity near IPM convergence, and yield the
    minimum-length solution on singular consistent systems."""

    name = "minres-qlp"

    def linear_system(self) -> str:
        return "Augmented system (K2), MINRES-QLP"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)

        def K2_mv(w):
            wx, wy = w[:n], w[n:]
            top = -theta_reg * wx + A.T @ wy
            bot = A @ wx + regD * wy
            return jnp.concatenate([top, bot])

        rhs = jnp.concatenate([xi_d, xi_p])
        sol = minres_qlp(K2_mv, rhs, rtol, maxiter)
        return sol[:n], sol[n:]


@dataclasses.dataclass(frozen=True)
class MinaresK2Backend(MinresK2Backend):
    """‖Ar‖-minimizing method on the augmented system (the MINARES role of
    the reference SID family, src/KKT/Krylov/defs.jl:9-17; Montoison,
    Orban & Saunders 2023). Implemented as conjugate residuals on the
    squared operator — K² is SPD for symmetric nonsingular K, and the CR
    residual of K²x = Kb is exactly K r, so the iterates minimize ‖K r‖
    over x ∈ K_k(K², Kb) (a subspace of the K_2k(K, b) the eponymous
    algorithm uses; same optimality criterion, two operator applications
    per iteration). Useful when the residual of the *normal* system is the
    quantity being driven down, e.g. noisy RHS near convergence.

    EXPERIMENTAL (round-5 end-to-end finding): squaring the operator
    squares its condition number; with late-IPM κ(K2) ~ 1e8-1e16 the
    squared system is numerically intractable in f64, and golden-LP
    solves stall at ITERATION_LIMIT even at 1e-4 tolerances. Passes the
    conformance kit on benign matrices only — same class as TriCG."""

    name = "minares"
    experimental = True

    def linear_system(self) -> str:
        return "Augmented system (K2), MINARES (CR on K²)"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * (m + n)

        def K2_mv(w):
            wx, wy = w[:n], w[n:]
            top = -theta_reg * wx + A.T @ wy
            bot = A @ wx + regD * wy
            return jnp.concatenate([top, bot])

        def K2sq_mv(w):
            return K2_mv(K2_mv(w))

        rhs = jnp.concatenate([xi_d, xi_p])
        sol = cr(K2sq_mv, K2_mv(rhs), lambda r: r, rtol, maxiter)
        return sol[:n], sol[n:]


def lsqr(matvec: Callable, rmatvec: Callable, b: jnp.ndarray, n: int,
         rtol, maxiter: int) -> jnp.ndarray:
    """LSQR (Paige & Saunders 1982): Golub-Kahan bidiagonalization solve of
    ``min ||A x - b||`` as one ``lax.while_loop``. Stops on the
    least-squares optimality estimate ``||A'r|| <= rtol * ||A'b||``."""
    dt = b.dtype
    one = jnp.ones((), dt)

    def safe(v):
        return jnp.where(v == 0, one, v)

    u = b
    beta = jnp.linalg.norm(u)
    u = u / safe(beta)
    v = rmatvec(u)
    alfa = jnp.linalg.norm(v)
    v = v / safe(alfa)
    x0 = jnp.zeros(n, dt)
    # ||A'b|| = alfa * beta
    tol = rtol * safe(alfa * beta)

    # carry: x, u, v, w, alfa, phibar, rhobar, k, atrnorm
    carry0 = (x0, u, v, v, alfa, beta, alfa, jnp.zeros((), jnp.int32),
              alfa * beta)

    def cond(c):
        *_, k, atr = c
        return (atr > tol) & (k < maxiter)

    def body(c):
        x, u, v, w, alfa, phibar, rhobar, k, _ = c
        u = matvec(v) - alfa * u
        beta = jnp.linalg.norm(u)
        u = u / safe(beta)
        v_new = rmatvec(u) - beta * v
        alfa_new = jnp.linalg.norm(v_new)
        v_new = v_new / safe(alfa_new)

        rho = jnp.sqrt(rhobar * rhobar + beta * beta)
        cs = rhobar / safe(rho)
        sn = beta / safe(rho)
        theta = sn * alfa_new
        rhobar_new = -cs * alfa_new
        phi = cs * phibar
        phibar_new = sn * phibar

        x = x + (phi / safe(rho)) * w
        w = v_new - (theta / safe(rho)) * w
        # ||A'r_k|| = phibar_{k+1} * alfa_{k+1} * |c_k| (Paige & Saunders
        # 1982, eq. 5.2).
        atrnorm = phibar_new * alfa_new * jnp.abs(cs)
        return (x, u, v_new, w, alfa_new, phibar_new, rhobar_new, k + 1,
                atrnorm)

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0]


def lsmr(matvec: Callable, rmatvec: Callable, b: jnp.ndarray, n: int,
         rtol, maxiter: int) -> jnp.ndarray:
    """LSMR (Fong & Saunders 2011): MINRES applied to the normal equations
    through Golub-Kahan bidiagonalization; ``||A'r_k||`` decreases
    monotonically and is tracked exactly by ``zetabar``."""
    dt = b.dtype
    one = jnp.ones((), dt)

    def safe(v):
        return jnp.where(v == 0, one, v)

    u = b
    beta = jnp.linalg.norm(u)
    u = u / safe(beta)
    v = rmatvec(u)
    alfa = jnp.linalg.norm(v)
    v = v / safe(alfa)

    zetabar = alfa * beta
    alfabar = alfa
    rho = one
    rhobar = one
    cbar = one
    sbar = jnp.zeros((), dt)
    h = v
    hbar = jnp.zeros(n, dt)
    x0 = jnp.zeros(n, dt)
    tol = rtol * safe(zetabar)   # ||A'b||

    carry0 = (x0, u, v, h, hbar, alfa, alfabar, rho, rhobar, cbar, sbar,
              zetabar, jnp.zeros((), jnp.int32), jnp.abs(zetabar))

    def cond(c):
        *_, k, atr = c
        return (atr > tol) & (k < maxiter)

    def body(c):
        (x, u, v, h, hbar, alfa, alfabar, rho, rhobar, cbar, sbar, zetabar,
         k, _) = c
        u = matvec(v) - alfa * u
        beta = jnp.linalg.norm(u)
        u = u / safe(beta)
        v_new = rmatvec(u) - beta * v
        alfa_new = jnp.linalg.norm(v_new)
        v_new = v_new / safe(alfa_new)

        # First rotation (as in LSQR).
        rho_new = jnp.sqrt(alfabar * alfabar + beta * beta)
        c1 = alfabar / safe(rho_new)
        s1 = beta / safe(rho_new)
        theta_new = s1 * alfa_new
        alfabar_new = c1 * alfa_new

        # Second rotation (the MINRES part).
        thetabar = sbar * rho_new
        rhotemp = cbar * rho_new
        rhobar_new = jnp.sqrt(rhotemp * rhotemp + theta_new * theta_new)
        cbar_new = rhotemp / safe(rhobar_new)
        sbar_new = theta_new / safe(rhobar_new)
        zeta = cbar_new * zetabar
        zetabar_new = -sbar_new * zetabar

        hbar = h - (thetabar * rho_new / safe(rho * rhobar)) * hbar
        x = x + (zeta / safe(rho_new * rhobar_new)) * hbar
        h = v_new - (theta_new / safe(rho_new)) * h

        return (x, u, v_new, h, hbar, alfa_new, alfabar_new, rho_new,
                rhobar_new, cbar_new, sbar_new, zetabar_new, k + 1,
                jnp.abs(zetabar_new))

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0]


@dataclasses.dataclass(frozen=True)
class LsqrK1Backend(KKTBackend):
    """LSQR on the damped least-squares formulation of K1 (the reference's
    LS family, reference: src/KKT/Krylov/defs.jl:25-29 — defined there but
    unwired; implemented here as a working backend). The normal equations
    ``(A E⁻¹ Aᵀ + F) dy = ξp + A E⁻¹ ξd`` with E = Θ⁻¹+Rp, F = Rd are the
    optimality conditions of

        min_dy || [E^(-1/2) Aᵀ; F^(1/2)] dy - [E^(-1/2) ξd; F^(-1/2) ξp] ||

    which LSQR solves via Golub-Kahan bidiagonalization — never forming
    A E⁻¹ Aᵀ and with better conditioning (κ(Ā) = √κ(K1))."""

    name = "lsqr"
    sweep_resid_atol = None   # matrix-free; see CgK1Backend
    systems = ("K1",)
    rtol: float = 0.0
    maxiter_factor: int = 10

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Normal equations (K1), LSQR on the damped LS form"

    def setup(self, A: jnp.ndarray) -> KrylovState:
        m, n = A.shape
        dt = A.dtype
        return KrylovState(A=A, d=jnp.ones(n, dt), theta_reg=jnp.ones(n, dt),
                           regD=jnp.ones(m, dt))

    update = CgK1Backend.update

    def _ls_solver(self):
        return lsqr

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m
        e_isqrt = 1.0 / jnp.sqrt(theta_reg)     # E^(-1/2)
        f_sqrt = jnp.sqrt(regD)                 # F^(1/2)

        def mv(dy):                             # Ā dy, stacked (n + m)
            return jnp.concatenate([e_isqrt * (A.T @ dy), f_sqrt * dy])

        def rmv(r):                             # Āᵀ r
            return A @ (e_isqrt * r[:n]) + f_sqrt * r[n:]

        bbar = jnp.concatenate([e_isqrt * xi_d, xi_p / f_sqrt])
        dy = self._ls_solver()(mv, rmv, bbar, m, rtol, maxiter)
        dx = (A.T @ dy - xi_d) / theta_reg
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)


@dataclasses.dataclass(frozen=True)
class LsmrK1Backend(LsqrK1Backend):
    """LSMR variant of :class:`LsqrK1Backend` (min-residual on the normal
    equations; ``||Ā'r||`` decreases monotonically — the safer choice when
    stopping early)."""

    name = "lsmr"

    def linear_system(self) -> str:
        return "Normal equations (K1), LSMR on the damped LS form"

    def _ls_solver(self):
        return lsmr


# ---------------------------------------------------------------------------
# LN (least-norm) family: CRAIG / LNLQ-CG / CRAIGMR
# ---------------------------------------------------------------------------

def craig(matvec: Callable, rmatvec: Callable, b: jnp.ndarray, nw: int,
          rtol, maxiter: int) -> jnp.ndarray:
    """CRAIG (Paige 1974): minimum-norm solution of the CONSISTENT
    underdetermined system ``A w = b`` via Golub-Kahan bidiagonalization
    (mathematically CG on ``A Aᵀ y = b`` with ``w = Aᵀ y``), as one
    ``lax.while_loop``. Also the CG transfer point of LNLQ
    (Estrin, Orban & Saunders 2019). Residual norm ``||b - A w_k|| =
    |β_{k+1} ζ_k|`` is tracked exactly; stops at ``rtol * ||b||``."""
    dt = b.dtype
    one = jnp.ones((), dt)

    def safe(v):
        return jnp.where(v == 0, one, v)

    beta1 = jnp.linalg.norm(b)
    u = b / safe(beta1)
    v = rmatvec(u)
    alfa = jnp.linalg.norm(v)
    v = v / safe(alfa)
    zeta = beta1 / safe(alfa)
    w = zeta * v
    tol = rtol * safe(beta1)

    # carry: w, u, v, alfa, zeta, k, rnorm
    carry0 = (w, u, v, alfa, zeta, jnp.ones((), jnp.int32),
              jnp.abs(beta1))

    def cond(c):
        *_, k, rnorm = c
        return (rnorm > tol) & (k < maxiter)

    def body(c):
        w, u, v, alfa, zeta, k, _ = c
        u_new = matvec(v) - alfa * u
        beta = jnp.linalg.norm(u_new)
        u_new = u_new / safe(beta)
        v_new = rmatvec(u_new) - beta * v
        alfa_new = jnp.linalg.norm(v_new)
        v_new = v_new / safe(alfa_new)
        rnorm = jnp.abs(beta * zeta)            # ||b - A w_k||
        zeta_new = -(beta / safe(alfa_new)) * zeta
        w = w + zeta_new * v_new
        return (w, u_new, v_new, alfa_new, zeta_new, k + 1, rnorm)

    out = jax.lax.while_loop(cond, body, carry0)
    return out[0]


@dataclasses.dataclass(frozen=True)
class CraigK1Backend(LsqrK1Backend):
    """CRAIG/LNLQ on the least-norm formulation of K1 (the reference's LN
    family, reference: src/KKT/Krylov/defs.jl:19-23 — defined there but
    unwired; implemented here as a working backend). With
    ``Â = [A E^(-1/2)  F^(1/2)]`` (full row rank since F = Rd > 0, so the
    system is always consistent) the minimum-norm problem

        min ||w||  s.t.  Â w = ξp + A E⁻¹ ξd

    has solution ``w = Âᵀ dy`` where ``(A E⁻¹ Aᵀ + F) dy = ξ̄`` is exactly
    K1 — and the second block of w recovers the K1 solution directly:
    ``dy = F^(-1/2) w₂`` (no LNLQ-style auxiliary-y recurrence needed).
    Never forms A E⁻¹ Aᵀ; κ(Â) = √κ(K1) like the LS family."""

    name = "craig"

    def linear_system(self) -> str:
        return "Normal equations (K1), CRAIG on the least-norm form"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m
        e_isqrt = 1.0 / jnp.sqrt(theta_reg)     # E^(-1/2)
        f_sqrt = jnp.sqrt(regD)                 # F^(1/2)

        def mv(w):                               # Â w, m-vector
            return A @ (e_isqrt * w[:n]) + f_sqrt * w[n:]

        def rmv(u):                              # Âᵀ u, (n + m)-vector
            return jnp.concatenate([e_isqrt * (A.T @ u), f_sqrt * u])

        bbar = xi_p + A @ (xi_d / theta_reg)
        w = craig(mv, rmv, bbar, n + m, rtol, maxiter)
        dy = w[n:] / f_sqrt
        dx = (A.T @ dy - xi_d) / theta_reg
        return dx, dy


@dataclasses.dataclass(frozen=True)
class CraigmrK1Backend(CraigK1Backend):
    """CRAIGMR role of the LN family: minimum-RESIDUAL iterates on the same
    least-norm system — MINRES applied to the SPD operator
    ``Â Âᵀ = A E⁻¹ Aᵀ + F`` in factored (Gram-free) form, with ``dy`` read
    off directly. Monotone residual decrease makes it the safer LN choice
    when stopping early, mirroring LSMR's role in the LS family."""

    name = "craigmr"

    def linear_system(self) -> str:
        return "Normal equations (K1), CRAIGMR (min-residual least-norm)"

    def _base_solve(self, state: KrylovState, xi_p, xi_d):
        A, theta_reg, regD = state.A, state.theta_reg, state.regD
        m, n = A.shape
        rtol = self.rtol or _sqrt_eps(A.dtype)
        maxiter = self.maxiter_factor * m

        def op(y):                               # (A E⁻¹ Aᵀ + F) y, Gram-free
            return A @ ((A.T @ y) / theta_reg) + regD * y

        bbar = xi_p + A @ (xi_d / theta_reg)
        dy = minres(op, bbar, rtol, maxiter)
        dx = (A.T @ dy - xi_d) / theta_reg
        return dx, dy

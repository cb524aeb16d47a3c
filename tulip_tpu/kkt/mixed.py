"""Mixed-precision K1 backend: f32 factorization, f64 refinement.

The O(m³) work (normal-equations Gram + Cholesky + factor inverse) runs in
f32 — at f32 rates where f64 is slower — while the O(m²) per-solve work (residuals + GEMV corrections) runs in f64. Iterative
refinement against the f64 augmented system recovers f64-grade solve
accuracy as long as eps_f32·cond(K) < 1; the IPM's regularization floors
keep cond(K) bounded, so pair this backend with ``PRegMin/DRegMin ≈ 1e-6``
rather than the f64 default √eps.

This is the designed answer to "survive bf32/f32 ill-conditioning near
convergence" — the reference sidesteps the
problem by running LAPACK/CHOLMOD in f64 and leaves refinement as a TODO
(reference: src/KKT/Dense/lapack.jl:117).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .base import KKTBackend


class MixedK1State(NamedTuple):
    A: jnp.ndarray          # (m, n) f64
    A32: jnp.ndarray        # (m, n) f32 copy
    d: jnp.ndarray          # (n,)  f64  D = (Θ⁻¹+Rp)⁻¹
    theta_reg: jnp.ndarray  # (n,)  f64
    regD: jnp.ndarray       # (m,)  f64
    Li32: jnp.ndarray       # (m, m) f32 inverse Cholesky factor


@dataclasses.dataclass(frozen=True)
class MixedK1Backend(KKTBackend):
    name = "dense-mixed"
    systems = ("K1",)
    refinement_steps: int = 3
    # Recursive blocked chol+inverse for the f32 factor at m >= this
    # (same rationale and machinery as DenseK1Backend.blocked_min).
    blocked_min: int = 4096

    def arithmetic(self, state) -> str:
        return "float32 factorization / float64 refinement"

    def linear_system(self) -> str:
        return "Normal equations (K1), mixed precision"

    def setup(self, A: jnp.ndarray) -> MixedK1State:
        m, n = A.shape
        A = A.astype(jnp.float64)
        return MixedK1State(
            A=A, A32=A.astype(jnp.float32),
            d=jnp.ones(n, jnp.float64),
            theta_reg=jnp.ones(n, jnp.float64),
            regD=jnp.ones(m, jnp.float64),
            Li32=jnp.eye(m, dtype=jnp.float32),
        )

    def update(self, state: MixedK1State, theta_inv, regP, regD,
               ) -> Tuple[MixedK1State, jnp.ndarray]:
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        B32 = state.A32 * jnp.sqrt(d).astype(jnp.float32)[None, :]
        K32 = B32 @ B32.T + jnp.diag(regD.astype(jnp.float32))
        m = K32.shape[-1]
        if m >= self.blocked_min:
            # Recursive blocked chol+inverse: GEMM-dominated (see
            # ops/blocked.py).
            from ..ops.blocked import cholesky_invfactor_blocked

            _, Li32 = cholesky_invfactor_blocked(K32)
            ok = jnp.all(jnp.isfinite(Li32))
            Li32 = jnp.where(ok, Li32, jnp.eye(m, dtype=jnp.float32))
        else:
            L32 = jnp.linalg.cholesky(K32)
            ok = jnp.all(jnp.isfinite(L32))
            L32 = jnp.where(ok, L32, jnp.eye(m, dtype=jnp.float32))
            Li32 = jax.scipy.linalg.solve_triangular(
                L32, jnp.eye(m, dtype=jnp.float32), lower=True)
        return (MixedK1State(A=state.A, A32=state.A32, d=d,
                             theta_reg=theta_reg, regD=regD, Li32=Li32), ok)

    def _f32_solve(self, state: MixedK1State, xi_p, xi_d):
        """One f32 core solve of the augmented system; f64 in/out."""
        A, d = state.A, state.d
        rhs = (xi_p + A @ (d * xi_d)).astype(jnp.float32)
        dy = (state.Li32.T @ (state.Li32 @ rhs)).astype(jnp.float64)
        dx = d * (A.T @ dy - xi_d)
        return dx, dy

    def solve(self, state: MixedK1State, xi_p, xi_d):
        dx, dy = self._f32_solve(state, xi_p, xi_d)
        # f64 refinement against the augmented system.
        for _ in range(self.refinement_steps):
            rd = xi_d - (-(state.theta_reg * dx) + state.A.T @ dy)
            rp = xi_p - (state.A @ dx + state.regD * dy)
            ddx, ddy = self._f32_solve(state, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

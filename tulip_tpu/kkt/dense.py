"""Dense K1 (normal equations) backend.

Solves the augmented system by pivoting on its (1,1) block: with
``D = (Θ⁻¹ + Rp)⁻¹`` the Schur complement is the SPD normal-equations matrix
``K = A D Aᵀ + Rd``, factorized by dense Cholesky
(reference semantics: src/KKT/Dense/lapack.jl:65-119; K1 system
src/KKT/systems.jl:34-54).

Design notes:
- ``K = (A √D)(A √D)ᵀ`` is a single large GEMM. The column scaling and
  the diagonal add fuse into the matmul's epilogue under XLA.
- ``jnp.linalg.cholesky`` lowers to XLA's blocked Cholesky; non-SPD inputs
  yield NaNs, which we turn into the boolean ``ok`` flag the IPM's
  regularization ladder branches on (no exceptions under jit).
- Methods are pure over ``DenseK1State`` with unbatched shapes; scenario
  batching is ``vmap`` at the IPM level.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .base import KKTBackend


class DenseK1State(NamedTuple):
    A: jnp.ndarray          # (m, n) constraint matrix (constant)
    d: jnp.ndarray          # (n,)  D = (Θ⁻¹ + Rp)⁻¹ diagonal
    theta_reg: jnp.ndarray  # (n,)  Θ⁻¹ + Rp (for refinement residuals)
    regD: jnp.ndarray       # (m,)
    L: jnp.ndarray          # (m, m) Cholesky factor of K


@dataclasses.dataclass(frozen=True)
class DenseK1Backend(KKTBackend):
    """K1 backend.

    ``inv_factor=True`` additionally inverts the Cholesky factor at update
    time (one TRSM with m right-hand sides) so that every subsequent
    backsolve becomes two GEMVs instead of two sequential triangular
    solves: the 3-8 per-iteration backsolves (reference profile:
    src/IPM/HSD/step.jl:63-136) become matrix-vector products. Slightly
    less accurate than backsolves — pair with ``refinement_steps>=1`` in
    f32.

    ``explicit_minv=True`` goes one step further and stores the full
    normal-equations inverse ``K⁻¹ = L⁻ᵀL⁻¹`` (one extra m×m GEMM at update
    time), making every backsolve a SINGLE GEMV: one op fewer per base
    solve (~10 ops per IPM iteration at CorrectionLimit=3); accuracy is
    comparable to the
    inverse-factor path (same ‖L⁻¹‖² amplification) — pair with
    ``refinement_steps>=1`` in f32.
    """

    name = "dense"
    systems = ("K1",)
    inv_factor: bool = False
    explicit_minv: bool = False
    # Recursive blocked Cholesky+inverse (ops/blocked.py) kicks in for
    # inv_factor updates at m >= blocked_min: all super-leaf work becomes
    # GEMMs instead of XLA's cholesky + TRSM.
    blocked_min: int = 4096

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Normal equations (K1)"

    def setup(self, A: jnp.ndarray) -> DenseK1State:
        m, n = A.shape
        dt = A.dtype
        return DenseK1State(
            A=A,
            d=jnp.ones(n, dtype=dt),
            theta_reg=jnp.ones(n, dtype=dt),
            regD=jnp.ones(m, dtype=dt),
            L=jnp.eye(m, dtype=dt),
        )

    def update(self, state: DenseK1State, theta_inv, regP, regD,
               ) -> Tuple[DenseK1State, jnp.ndarray]:
        A = state.A
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        B = A * jnp.sqrt(d)[None, :]
        K = B @ B.T + jnp.diag(regD)
        use_blocked = ((self.inv_factor or self.explicit_minv)
                       and K.shape[-1] >= self.blocked_min)
        if use_blocked:
            from ..ops.blocked import cholesky_invfactor_blocked

            _, L = cholesky_invfactor_blocked(K)   # L holds L^-1
            ok = jnp.all(jnp.isfinite(L))
            L = jnp.where(ok, L, jnp.eye(K.shape[-1], dtype=K.dtype))
            if self.explicit_minv:
                L = L.T @ L
        else:
            L = jnp.linalg.cholesky(K)
            ok = jnp.all(jnp.isfinite(L))
            # Replace a failed factor with identity so downstream solves
            # stay finite while the regularization-bump loop retries.
            L = jnp.where(ok, L, jnp.eye(K.shape[-1], dtype=K.dtype))
            if self.inv_factor or self.explicit_minv:
                # Store L^-1 instead of L: one TRSM with m RHS now,
                # GEMV-only solves afterwards.
                L = jax.scipy.linalg.solve_triangular(
                    L, jnp.eye(K.shape[-1], dtype=K.dtype), lower=True)
                if self.explicit_minv:
                    # Store K^-1 = L^-T L^-1: single-GEMV solves.
                    L = L.T @ L
        return (DenseK1State(A=A, d=d, theta_reg=theta_reg, regD=regD, L=L),
                ok)

    def _base_solve(self, state: DenseK1State, xi_p, xi_d):
        A, d, L = state.A, state.d, state.L
        rhs = xi_p + A @ (d * xi_d)
        if self.explicit_minv:
            dy = L @ rhs
        elif self.inv_factor:
            dy = L.T @ (L @ rhs)
        else:
            w = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
            dy = jax.scipy.linalg.solve_triangular(L.T, w, lower=False)
        dx = d * (A.T @ dy - xi_d)
        return dx, dy

    def solve(self, state: DenseK1State, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)

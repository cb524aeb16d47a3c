"""Dense K2 (augmented system) backend via LDLᵀ without pivoting.

Assembles the full symmetric quasi-definite matrix
(reference semantics: src/KKT/Cholmod/sqd.jl:42-53, src/KKT/systems.jl:8-32)::

    K2 = [-(Θ⁻¹ + Rp)   Aᵀ]
         [   A          Rd]

Quasi-definite matrices are strongly factorizable: LDLᵀ without pivoting
exists for any symmetric permutation (Vanderbei 1995), which is what makes a
static, branchless factorization possible — no dynamic pivot
selection. The factorization is a ``lax.fori_loop`` of rank-1-free column
updates (one matvec per column); fine for the capability-parity path. The
performance path is the K1 backend (single GEMM + XLA Cholesky).

K2 matters when A has dense columns (K1's AΘAᵀ fills in) or for
ill-conditioned problems (reference defaults to K2,
src/KKT/KKT.jl:134-141).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .base import KKTBackend


def ldl_nopivot(K: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unpivoted LDLᵀ: K = L D Lᵀ with unit lower L, diagonal D.

    Returns (L, d, ok). ``ok`` is False if a zero/non-finite pivot appears.
    """
    N = K.shape[0]
    dt = K.dtype
    idx = jnp.arange(N)

    def body(j, carry):
        L, d = carry
        # Columns < j of L are final; mask the rest out of the update.
        colmask = (idx < j).astype(dt)          # (N,)
        # c = K[:, j] - L[:, :j] @ (d[:j] * L[j, :j])
        c = K[:, j] - L @ (d * L[j, :] * colmask)
        dj = c[j]
        dj_safe = jnp.where(dj == 0, jnp.ones((), dt), dj)
        colj = jnp.where(idx > j, c / dj_safe,
                         jnp.where(idx == j, jnp.ones((), dt),
                                   jnp.zeros((), dt)))
        L = L.at[:, j].set(colj)
        d = d.at[j].set(dj)
        return L, d

    L0 = jnp.zeros((N, N), dtype=dt)
    d0 = jnp.zeros(N, dtype=dt)
    L, d = jax.lax.fori_loop(0, N, body, (L0, d0))
    ok = jnp.all(jnp.isfinite(L)) & jnp.all(jnp.isfinite(d)) & jnp.all(d != 0)
    return L, d, ok


class DenseK2State(NamedTuple):
    A: jnp.ndarray          # (m, n)
    theta_reg: jnp.ndarray  # (n,)  Θ⁻¹ + Rp
    regD: jnp.ndarray       # (m,)
    L: jnp.ndarray          # (m+n, m+n) unit lower factor
    d: jnp.ndarray          # (m+n,) pivots


@dataclasses.dataclass(frozen=True)
class DenseK2Backend(KKTBackend):
    name = "dense-ldl"
    systems = ("K2",)

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Augmented system (K2)"

    def setup(self, A: jnp.ndarray) -> DenseK2State:
        m, n = A.shape
        dt = A.dtype
        return DenseK2State(
            A=A,
            theta_reg=jnp.ones(n, dtype=dt),
            regD=jnp.ones(m, dtype=dt),
            L=jnp.eye(m + n, dtype=dt),
            d=jnp.ones(m + n, dtype=dt),
        )

    def update(self, state: DenseK2State, theta_inv, regP, regD,
               ) -> Tuple[DenseK2State, jnp.ndarray]:
        A = state.A
        m, n = A.shape
        theta_reg = theta_inv + regP
        K = jnp.zeros((m + n, m + n), dtype=A.dtype)
        K = K.at[:n, :n].set(jnp.diag(-theta_reg))
        K = K.at[:n, n:].set(A.T)
        K = K.at[n:, :n].set(A)
        K = K.at[n:, n:].set(jnp.diag(regD))
        L, d, ok = ldl_nopivot(K)
        eyeN = jnp.eye(m + n, dtype=A.dtype)
        L = jnp.where(ok, L, eyeN)
        d = jnp.where(ok, d, jnp.ones(m + n, dtype=A.dtype))
        return (DenseK2State(A=A, theta_reg=theta_reg, regD=regD, L=L, d=d),
                ok)

    def _base_solve(self, state: DenseK2State, xi_p, xi_d):
        n = state.A.shape[1]
        rhs = jnp.concatenate([xi_d, xi_p])
        w = jax.scipy.linalg.solve_triangular(
            state.L, rhs, lower=True, unit_diagonal=True)
        w = w / state.d
        sol = jax.scipy.linalg.solve_triangular(
            state.L.T, w, lower=False, unit_diagonal=True)
        return sol[:n], sol[n:]

    def solve(self, state: DenseK2State, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)

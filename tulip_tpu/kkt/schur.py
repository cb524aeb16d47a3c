"""Distributed Schur-complement KKT backend for block-angular LPs.

Solves the augmented system of a two-stage stochastic LP by eliminating the
per-scenario blocks and reducing onto the first stage. Derivation — the
augmented system (reference contract: src/KKT/KKT.jl:65-100) with the
block-angular A of :class:`tulip_tpu.parallel.block_angular.BlockAngularLPData`
splits into, per scenario k (D = (Θ⁻¹+Rp)⁻¹ diagonal, split as D0/Dk;
Rd split as Rd0/Rdk):

    -(Dk⁻¹) dxk + Wkᵀ dyk                    = ξdk
    Tk dx0 + Wk dxk + Rdk dyk                = ξpk
    -(D0⁻¹) dx0 + A0ᵀ dy0 + Σk Tkᵀ dyk      = ξd0
    A0 dx0 + Rd0 dy0                         = ξp0

Eliminating (dxk, dyk) with Mk = Wk Dk Wkᵀ + Rdk gives the first-stage
SPD system

    (H + A0ᵀ Rd0⁻¹ A0) dx0 = A0ᵀ Rd0⁻¹ ξp0 − (ξd0 − Σk Tkᵀ Mk⁻¹ rk)
    H  = D0⁻¹ + Σk Tkᵀ Mk⁻¹ Tk            (n0 × n0 Schur complement)
    rk = ξpk + Wk Dk ξdk

Parallel structure: everything indexed by k is batched (K, …) arrays; with
the K axis sharded over a device mesh, the per-scenario Cholesky of Mk, the
triangular solves, and the Gk = Tkᵀ Mk⁻¹ Tk Gram products are local to each
device, and the two ``Σk`` reductions (an n0×n0 matrix in ``update``, an
n0 vector in ``solve``) become XLA ``psum`` collectives — the textbook
distributed Schur-complement pattern.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .base import KKTBackend


class SchurState(NamedTuple):
    # Constant blocks
    A0: jnp.ndarray      # (m0, n0)
    T: jnp.ndarray       # (K, mk, n0)
    W: jnp.ndarray       # (K, mk, nk)
    # Per-update quantities
    d0: jnp.ndarray      # (n0,)   D0 diagonal
    dk: jnp.ndarray      # (K, nk) Dk diagonals
    theta_reg: jnp.ndarray  # (n,) flat Θ⁻¹+Rp (refinement residuals)
    regD0: jnp.ndarray   # (m0,)
    regDk: jnp.ndarray   # (K, mk)
    Lk: jnp.ndarray      # (K, mk, mk) Cholesky factors of Mk
    Ls: jnp.ndarray      # (n0, n0)    Cholesky factor of the 1st-stage system


def _tri_solve(L, B, lower=True, trans=False):
    return jax.scipy.linalg.solve_triangular(
        L, B, lower=lower, trans=1 if trans else 0)


def _cho_solve_batched(L, B):
    """Solve M X = B given batched Cholesky L of M; B is (K, mk) or
    (K, mk, p)."""
    w = jax.vmap(lambda Lk, bk: _tri_solve(Lk, bk))(L, B)
    return jax.vmap(lambda Lk, wk: _tri_solve(Lk, wk, trans=True))(L, w)


@dataclasses.dataclass(frozen=True)
class SchurK1Backend(KKTBackend):
    """K1-style Schur-complement backend over block-angular data."""

    name = "schur"
    systems = ("K1",)

    def arithmetic(self, state) -> str:
        return str(state.A0.dtype)

    def linear_system(self) -> str:
        return "Block-angular Schur complement (K1)"

    def setup(self, A):
        raise TypeError(
            "SchurK1Backend requires BlockAngularLPData; use setup_data")

    def setup_data(self, dat) -> SchurState:
        dt = dat.c.dtype
        K, mk, nk, n0, m0 = dat.K, dat.mk, dat.nk, dat.n0, dat.m0
        return SchurState(
            A0=dat.A0, T=dat.T, W=dat.W,
            d0=jnp.ones(n0, dt), dk=jnp.ones((K, nk), dt),
            theta_reg=jnp.ones(n0 + K * nk, dt),
            regD0=jnp.ones(m0, dt), regDk=jnp.ones((K, mk), dt),
            Lk=jnp.stack([jnp.eye(mk, dtype=dt)] * K),
            Ls=jnp.eye(n0, dtype=dt),
        )

    def update(self, state: SchurState, theta_inv, regP, regD,
               ) -> Tuple[SchurState, jnp.ndarray]:
        A0, T, W = state.A0, state.T, state.W
        K, mk, nk = T.shape[0], T.shape[1], W.shape[2]
        n0 = A0.shape[1]
        m0 = A0.shape[0]

        theta_reg = theta_inv + regP
        d0 = 1.0 / theta_reg[:n0]
        dk = (1.0 / theta_reg[n0:]).reshape(K, nk)
        regD0 = regD[:m0]
        regDk = regD[m0:].reshape(K, mk)

        # Per-scenario Mk = Wk Dk Wkᵀ + Rdk and its Cholesky (local work).
        WD = W * dk[:, None, :]
        M = jnp.einsum("kij,klj->kil", WD, W)
        M = M + jax.vmap(jnp.diag)(regDk)
        Lk = jnp.linalg.cholesky(M)
        ok_k = jnp.all(jnp.isfinite(Lk))
        Lk = jnp.where(ok_k, Lk, jnp.eye(mk, dtype=M.dtype)[None])

        # Gk = Tkᵀ Mk⁻¹ Tk via Zk = Lk⁻¹ Tk ; G = Σk Zkᵀ Zk.
        # The Σk over the sharded K axis is the distributed reduction
        # (psum over ICI under GSPMD).
        Z = jax.vmap(lambda L, Tk: _tri_solve(L, Tk))(Lk, T)
        G = jnp.einsum("kij,kil->jl", Z, Z)

        # First-stage system S = D0⁻¹ + G + A0ᵀ Rd0⁻¹ A0.
        S = jnp.diag(1.0 / d0) + G + A0.T @ (A0 / regD0[:, None])
        Ls = jnp.linalg.cholesky(S)
        ok = ok_k & jnp.all(jnp.isfinite(Ls))
        Ls = jnp.where(ok, Ls, jnp.eye(n0, dtype=S.dtype))

        return (SchurState(A0=A0, T=T, W=W, d0=d0, dk=dk,
                           theta_reg=theta_reg, regD0=regD0, regDk=regDk,
                           Lk=Lk, Ls=Ls), ok)

    def _base_solve(self, state: SchurState, xi_p, xi_d):
        A0, T, W = state.A0, state.T, state.W
        K, mk, nk = T.shape[0], T.shape[1], W.shape[2]
        n0 = A0.shape[1]
        m0 = A0.shape[0]

        xi_p0, xi_pk = xi_p[:m0], xi_p[m0:].reshape(K, mk)
        xi_d0, xi_dk = xi_d[:n0], xi_d[n0:].reshape(K, nk)

        # rk = ξpk + Wk Dk ξdk ; uk = Mk⁻¹ rk  (local per scenario).
        rk = xi_pk + jnp.einsum("kij,kj->ki", W, state.dk * xi_dk)
        uk = _cho_solve_batched(state.Lk, rk)

        # t = ξd0 − Σk Tkᵀ uk  (n0-vector psum).
        t = xi_d0 - jnp.einsum("kij,ki->j", T, uk)

        # First-stage solve.
        rhs0 = A0.T @ (xi_p0 / state.regD0) - t
        w = _tri_solve(state.Ls, rhs0)
        dx0 = _tri_solve(state.Ls, w, trans=True)
        dy0 = (xi_p0 - A0 @ dx0) / state.regD0

        # Back-substitute scenarios (local).
        Tdx0 = jnp.einsum("kij,j->ki", T, dx0)
        dyk = uk - _cho_solve_batched(state.Lk, Tdx0)
        dxk = state.dk * (jnp.einsum("kij,ki->kj", W, dyk) - xi_dk)

        dx = jnp.concatenate([dx0, dxk.reshape(-1)])
        dy = jnp.concatenate([dy0, dyk.reshape(-1)])
        return dx, dy

    def _residual(self, state: SchurState, xi_p, xi_d, dx, dy):
        """Augmented-system residuals using the blocked operator."""
        A0, T, W = state.A0, state.T, state.W
        K, mk, nk = T.shape[0], T.shape[1], W.shape[2]
        n0, m0 = A0.shape[1], A0.shape[0]
        dx0, dxk = dx[:n0], dx[n0:].reshape(K, nk)
        dy0, dyk = dy[:m0], dy[m0:].reshape(K, mk)

        # Aᵀdy
        At_dy = jnp.concatenate([
            A0.T @ dy0 + jnp.einsum("kij,ki->j", T, dyk),
            jnp.einsum("kij,ki->kj", W, dyk).reshape(-1)])
        # A dx
        A_dx = jnp.concatenate([
            A0 @ dx0,
            (jnp.einsum("kij,j->ki", T, dx0)
             + jnp.einsum("kij,kj->ki", W, dxk)).reshape(-1)])
        regD = jnp.concatenate([state.regD0, state.regDk.reshape(-1)])
        rd = xi_d - (-(state.theta_reg * dx) + At_dy)
        rp = xi_p - (A_dx + regD * dy)
        return rd, rp

    def solve(self, state: SchurState, xi_p, xi_d):
        dx, dy = self._base_solve(state, xi_p, xi_d)
        for _ in range(self.refinement_steps):
            rd, rp = self._residual(state, xi_p, xi_d, dx, dy)
            ddx, ddy = self._base_solve(state, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

"""Dense-column splitting K1 backend: tiled sparse Cholesky on the sparse
part + Sherman-Morrison-Woodbury for the dense columns.

This covers the role the reference fills by defaulting to CHOLMOD LDLᵀ on
the augmented system (reference: src/KKT/KKT.jl:134-141): a handful of
dense columns in A densify the normal matrix K1 = AΘAᵀ completely and
defeat any sparse K1 factorization. The classic production alternative to
switching systems (PCx, Andersen & Andersen) is to split A = As + U eᵀ:

    K1 = As Θs Asᵀ + Rd  +  U Θd Uᵀ        (U = the k dense columns)
         └────── B: sparse, SPD ──────┘     └ rank-k correction ┘

factor B with the tile-granular Cholesky (kkt/sparse.py) and apply

    K1⁻¹ r = B⁻¹r − B⁻¹U (Θd⁻¹ + Uᵀ B⁻¹ U)⁻¹ Uᵀ B⁻¹ r.

Every piece is symmetric positive definite — Cholesky is backward stable
regardless of conditioning, unlike unpivoted block LDLᵀ of the mixed
quasi-definite system — and SMW's forward error at extreme late-IPM Θ is
absorbed by the shared iterative-refinement sweeps on the true augmented
system (the full A, including dense columns).

Device cost per IPM iteration: one tiled sparse factorization + k extra
tiled backsolves + a (k, k) Cholesky; per solve: one tiled backsolve +
two skinny GEMVs. All dense ops; k is the (small) dense-column count.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .sparse import SparseK1Backend, SparseK1LevelState, SparseK1State
from .sparse_ldl import dense_threshold


class SplitK1State(NamedTuple):
    inner: SparseK1State      # tiled factorization of B = AsΘsAsᵀ + Rd
    A: jnp.ndarray            # (m, n) FULL constraint matrix — or, on the
                              # sparse-first path, the SparseLPData whose
                              # registered operators provide the full
                              # A·x / Aᵀ·y (never a dense (m, n) array)
    U: jnp.ndarray            # (m, k) the dense columns
    dense_idx: jnp.ndarray    # (k,) int32 column indices of U in A
    V: jnp.ndarray            # (m, k) B⁻¹ U after update
    Lc: jnp.ndarray           # (k, k) Cholesky factor of Θd⁻¹ + Uᵀ B⁻¹ U
    theta_reg: jnp.ndarray    # (n,)  Θ⁻¹ + Rp
    regD: jnp.ndarray         # (m,)


@dataclasses.dataclass(frozen=True)
class SplitK1Backend(KKTBackend):
    """K1 via tiled sparse Cholesky + SMW dense-column correction."""

    name = "sparse-smw"
    systems = ("K1",)
    block: int = 64
    # Forwarded to the inner tiled-K1 backend (kkt/sparse.py): "level" =
    # elimination-level batched execution, "column" = fori_loop schedule.
    schedule: str = "level"

    def _inner(self) -> SparseK1Backend:
        # Refinement runs at THIS level on the full A; the inner backend's
        # tile solves are used raw.
        return SparseK1Backend(block=self.block, refinement_steps=0,
                               schedule=self.schedule)

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return ("Normal equations (K1), tiled sparse Cholesky + "
                "SMW dense-column splitting")

    # -- host symbolic ----------------------------------------------------
    def setup_data(self, dat):
        """Sparse-first LP data: the dense columns were already split out
        at the data level (ipm/sparse_data.py, A = As + U eᵀ with the
        tile plan on As); build the inner level state from the compressed
        blocks and keep the SparseLPData itself as the full operator."""
        from ..ipm.sparse_data import SparseLPData
        if not isinstance(dat, SparseLPData):
            return self.setup(dat.A)
        if dat.U.shape[1] == 0:
            # No dense columns: plain tiled path via the inner backend.
            return self._inner().setup_data(dat)
        inner = SparseK1Backend(
            block=dat.Apc.shape[1], refinement_steps=0,
            schedule="level")._setup_from_sparse_data(dat)
        m = dat.perm.shape[0]
        n = dat.c.shape[0]
        k = dat.U.shape[1]
        dt = dat.Apc.dtype
        return SplitK1State(
            inner=inner,
            A=dat,
            U=dat.U,
            dense_idx=dat.dense_idx,
            V=jnp.zeros((m, k), dt),
            Lc=jnp.eye(k, dtype=dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones(m, dt),
        )

    def _full_mv(self, Aor, x):
        if isinstance(Aor, jnp.ndarray):
            return Aor @ x
        from ..ipm.data import matvec
        return matvec(Aor, x)

    def _full_rmv(self, Aor, y):
        if isinstance(Aor, jnp.ndarray):
            return Aor.T @ y
        from ..ipm.data import rmatvec
        return rmatvec(Aor, y)

    def setup(self, A: jnp.ndarray):
        A_np = np.asarray(A)
        m, n = A_np.shape
        colnnz = (np.abs(A_np) > 0).sum(axis=0)
        dense_idx = np.flatnonzero(colnnz >= dense_threshold(m))
        if dense_idx.size == 0 or dense_idx.size > max(64, 0.02 * n):
            # Nothing to split (or too much): plain tiled / dense paths.
            return self._dense().setup(A)
        As_np = A_np.copy()
        As_np[:, dense_idx] = 0.0
        inner = self._inner().setup(As_np)
        if not isinstance(inner, (SparseK1State, SparseK1LevelState)):
            return self._dense().setup(A)
        k = dense_idx.size
        dt = A.dtype
        return SplitK1State(
            inner=inner,
            A=A,
            U=A[:, jnp.asarray(dense_idx)],
            dense_idx=jnp.asarray(dense_idx, jnp.int32),
            V=jnp.zeros((m, k), dt),
            Lc=jnp.eye(k, dtype=dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones(m, dt),
        )

    # -- device numeric ---------------------------------------------------
    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, (SparseK1State, SparseK1LevelState)):
            # No-dense-column SparseLPData routed to the plain tiled path.
            return SparseK1Backend(
                schedule=self.schedule,
                refinement_steps=self.refinement_steps).update(
                    state, theta_inv, regP, regD)
        st = state
        inner_be = self._inner()
        theta_reg = theta_inv + regP
        # The zeroed dense columns of As contribute nothing to B whatever
        # their θ, so the inner backend can be fed the full vectors.
        inner, ok1 = inner_be.update(st.inner, theta_inv, regP, regD)

        # V = B⁻¹ U (k tiled backsolves, batched via vmap).
        def bsolve(u):
            rhs_b = inner_be._to_blocked(inner, u)
            return inner_be._from_blocked(
                inner, inner_be._solve_K_blocked(inner, rhs_b))

        V = jax.vmap(bsolve, in_axes=1, out_axes=1)(st.U)
        # C = Θd⁻¹ + Uᵀ B⁻¹ U  (SPD, (k, k)).
        C = jnp.diag(theta_reg[st.dense_idx]) + st.U.T @ V
        Lc = jnp.linalg.cholesky(C)
        ok2 = jnp.all(jnp.isfinite(Lc))
        Lc = jnp.where(ok2, Lc, jnp.eye(Lc.shape[0], dtype=Lc.dtype))
        new = SplitK1State(inner=inner, A=st.A, U=st.U,
                           dense_idx=st.dense_idx, V=V, Lc=Lc,
                           theta_reg=theta_reg, regD=regD)
        return new, ok1 & ok2

    # -- solve ------------------------------------------------------------
    def _k1_solve(self, st: SplitK1State, r):
        """K1⁻¹ r via SMW over the tiled factorization of B."""
        inner_be = self._inner()
        t = inner_be._from_blocked(
            st.inner,
            inner_be._solve_K_blocked(st.inner,
                                      inner_be._to_blocked(st.inner, r)))
        w = st.U.T @ t
        w = jax.scipy.linalg.solve_triangular(st.Lc, w, lower=True)
        w = jax.scipy.linalg.solve_triangular(st.Lc.T, w, lower=False)
        return t - st.V @ w

    def _base_solve(self, st: SplitK1State, xi_p, xi_d):
        d = 1.0 / st.theta_reg
        dy = self._k1_solve(st, xi_p + self._full_mv(st.A, d * xi_d))
        dx = d * (self._full_rmv(st.A, dy) - xi_d)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        if isinstance(state, (SparseK1State, SparseK1LevelState)):
            # setup_data routed a no-dense-column SparseLPData to the
            # plain tiled path.
            return SparseK1Backend(
                schedule=self.schedule,
                refinement_steps=self.refinement_steps).solve(
                    state, xi_p, xi_d)
        st = state
        dx, dy = self._base_solve(st, xi_p, xi_d)
        # Refinement on the TRUE augmented system via the full operators
        # (the base-class _refine assumes a dense state.A).
        for _ in range(self.refinement_steps):
            rd = xi_d - (-(st.theta_reg * dx) + self._full_rmv(st.A, dy))
            rp = xi_p - (self._full_mv(st.A, dx) + st.regD * dy)
            ddx, ddy = self._base_solve(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

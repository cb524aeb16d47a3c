"""Banded K1 backend: host symbolic analysis + blocked band Cholesky.

The TPU answer to sparse direct factorization (SURVEY §7 M4): no CHOLMOD
exists on TPU, and scalar sparse factorization is hostile to the hardware.
Instead:

- HOST (symbolic, at ``setup``): build the sparsity pattern of the normal
  matrix K = A Aᵀ, reorder rows with reverse Cuthill-McKee to minimize
  bandwidth, and emit a STATIC solve plan: the row permutation and a block
  size bw such that the permuted K is block-tridiagonal with (bw, bw)
  dense blocks. This is the reference's CHOLMOD symbolic-analysis role
  (reference: src/KKT/Cholmod/sqd.jl:19) re-cast as "host emits a static
  plan" (SURVEY §7 design translation).
- DEVICE (numeric, at ``update``/``solve``): block-tridiagonal Cholesky

      L₁ = chol(D₁);  Mᵢ = Eᵢ L₍ᵢ₋₁₎⁻ᵀ;  Lᵢ = chol(Dᵢ − Mᵢ Mᵢᵀ)

  as a ``lax.scan`` of dense (bw, bw) ops — O(m·bw²) flops instead of
  the dense O(m³) — with scan-based block forward/backward substitution.

Falls back to the dense inverse-factor backend when the reordered
bandwidth gives no advantage (2·bw ≥ m). Correct for ANY matrix; fast when
the problem has banded/staircase structure (time-structured, control,
transport chains).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .sparse import SparseK1Backend, SparseK1LevelState


def rcm_bandwidth(A: np.ndarray, use_native: bool = True,
                  ) -> Tuple[np.ndarray, int]:
    """Reverse Cuthill-McKee ordering of the K = A Aᵀ pattern.

    Returns (perm, bandwidth of P K Pᵀ). Prefers the native C++ engine
    (native/symbolic.cpp via kkt/native.py); falls back to scipy."""
    if use_native:
        from .native import rcm_native
        out = rcm_native(A)
        if out is not None:
            return out

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    # int32 accumulator: with int8, >=128 shared columns overflows and can
    # wrap to exactly 0 (e.g. 512 ≡ 0 mod 256), silently erasing K entries
    # and mis-classifying dense matrices as banded.
    pattern = sp.csr_matrix((np.abs(A) > 0).astype(np.int32))
    Kpat = (pattern @ pattern.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))
    Kp = Kpat[perm][:, perm].tocoo()
    bw = int(np.max(np.abs(Kp.row - Kp.col))) if Kp.nnz else 0
    return perm, bw


class BandedK1State(NamedTuple):
    """Static plan + numeric factors. ``perm.shape[0]`` carries the true
    row count m (padded rows of Ap are zero; their pivots are identity)."""

    Ap: jnp.ndarray      # (nb, bw, n) permuted + padded rows, blocked
    perm: jnp.ndarray    # (m,) int32 row permutation
    d: jnp.ndarray       # (n,)
    theta_reg: jnp.ndarray
    regD: jnp.ndarray    # (nb, bw) permuted + padded (1.0 on padding)
    L: jnp.ndarray       # (nb, bw, bw) diagonal Cholesky blocks
    M: jnp.ndarray       # (nb, bw, bw) subdiagonal factors (M[0] = 0)


def _to_blocked(st: BandedK1State, v: jnp.ndarray) -> jnp.ndarray:
    """Unpermuted (m,) row vector -> permuted padded (nb, bw)."""
    m = st.perm.shape[0]
    nb, bw, _ = st.Ap.shape
    return jnp.pad(v[st.perm], (0, nb * bw - m)).reshape(nb, bw)


def _from_blocked(st: BandedK1State, vb: jnp.ndarray) -> jnp.ndarray:
    """Permuted padded (nb, bw) -> unpermuted (m,)."""
    m = st.perm.shape[0]
    flat = vb.reshape(-1)[:m]
    return jnp.zeros(m, vb.dtype).at[st.perm].set(flat)


@dataclasses.dataclass(frozen=True)
class BandedK1Backend(KKTBackend):
    """K1 via RCM-permuted block-tridiagonal Cholesky."""

    name = "banded"
    systems = ("K1",)
    # The symbolic bandwidth is rounded up to a multiple of this (dense
    # tile shapes).
    min_block: int = 64
    # "level": execute through the shared nested-dissection level engine
    # (kkt/levels.py via kkt/sparse.py) — the band's elimination chain
    # becomes a log-depth tree of batched tile ops. "scan": the round-3
    # sequential block-tridiagonal lax.scan.
    schedule: str = "level"

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def _level(self, block: int) -> SparseK1Backend:
        return SparseK1Backend(block=block, schedule="level",
                               refinement_steps=self.refinement_steps)

    def arithmetic(self, state) -> str:
        if isinstance(state, (BandedK1State, SparseK1LevelState)):
            return str(state.Ap.dtype if isinstance(state, BandedK1State)
                       else state.Apc.dtype)
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Normal equations (K1), RCM block-tridiagonal"

    # -- host symbolic ---------------------------------------------------
    def setup(self, A: jnp.ndarray):
        A_np = np.asarray(A)
        m, n = A_np.shape
        perm, bw = rcm_bandwidth(A_np)
        bw_block = max(self.min_block,
                       -(-max(bw, 1) // self.min_block) * self.min_block)
        if 2 * bw_block >= m:
            return self._dense().setup(A)  # no banded advantage
        if self.schedule == "level":
            # Bandwidth-sized tiles through the shared level engine; the
            # gate may reject (tiny chains), then keep the scan path.
            st = self._level(min(bw_block, 128)).setup(A_np)
            if isinstance(st, SparseK1LevelState):
                return st
        nb = -(-m // bw_block)
        Ap = np.zeros((nb * bw_block, n), dtype=A_np.dtype)
        Ap[:m] = A_np[perm]
        dt = A.dtype
        return BandedK1State(
            Ap=jnp.asarray(Ap.reshape(nb, bw_block, n)),
            perm=jnp.asarray(perm, jnp.int32),
            d=jnp.ones(n, dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones((nb, bw_block), dt),
            L=jnp.stack([jnp.eye(bw_block, dtype=dt)] * nb),
            M=jnp.zeros((nb, bw_block, bw_block), dt),
        )

    # -- device numeric --------------------------------------------------
    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK1LevelState):
            return self._level(self.min_block).update(
                state, theta_inv, regP, regD)
        st = state
        nb, bw, n = st.Ap.shape
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = _to_blocked(st, regD)
        # Padded rows get unit pivots.
        m = st.perm.shape[0]
        pad_mask = (jnp.arange(nb * bw) >= m).reshape(nb, bw)
        regDb = jnp.where(pad_mask, 1.0, regDb)

        Ad = st.Ap * d[None, None, :]
        # Diagonal blocks D_i = A_i D A_iᵀ + diag(regD_i).
        D = jnp.einsum("bij,bkj->bik", Ad, st.Ap)
        D = D + jax.vmap(jnp.diag)(regDb)
        # Subdiagonal blocks E_i = A_i D A_{i-1}ᵀ (i >= 1).
        E = jnp.einsum("bij,bkj->bik", Ad[1:], st.Ap[:-1])

        eye = jnp.eye(bw, dtype=D.dtype)

        def step(L_prev, DE):
            Di, Ei = DE
            Mi = jax.scipy.linalg.solve_triangular(
                L_prev, Ei.T, lower=True).T          # M_i = E_i L_{i-1}^-T
            Li = jnp.linalg.cholesky(Di - Mi @ Mi.T)
            ok_i = jnp.all(jnp.isfinite(Li)) & jnp.all(jnp.isfinite(Mi))
            Li = jnp.where(ok_i, Li, eye)
            Mi = jnp.where(ok_i, Mi, jnp.zeros_like(Mi))
            return Li, (Li, Mi, ok_i)

        L0 = jnp.linalg.cholesky(D[0])
        ok0 = jnp.all(jnp.isfinite(L0))
        L0 = jnp.where(ok0, L0, eye)
        _, (Ls, Ms, oks) = jax.lax.scan(step, L0, (D[1:], E))
        L = jnp.concatenate([L0[None], Ls])
        M = jnp.concatenate([jnp.zeros((1, bw, bw), D.dtype), Ms])
        ok = ok0 & jnp.all(oks)
        return (BandedK1State(Ap=st.Ap, perm=st.perm, d=d,
                              theta_reg=theta_reg, regD=regDb, L=L, M=M),
                ok)

    def _band_solve_K(self, st: BandedK1State, rhs_b):
        """(P K Pᵀ) y = rhs via block forward/backward substitution."""

        def fwd(y_prev, LMr):
            Li, Mi, ri = LMr
            yi = jax.scipy.linalg.solve_triangular(
                Li, ri - Mi @ y_prev, lower=True)
            return yi, yi

        y0 = jax.scipy.linalg.solve_triangular(st.L[0], rhs_b[0], lower=True)
        _, ys = jax.lax.scan(fwd, y0, (st.L[1:], st.M[1:], rhs_b[1:]))
        y = jnp.concatenate([y0[None], ys])

        def bwd(x_next, LMy):
            Li, Mi_next, yi = LMy
            xi = jax.scipy.linalg.solve_triangular(
                Li.T, yi - Mi_next.T @ x_next, lower=False)
            return xi, xi

        x_last = jax.scipy.linalg.solve_triangular(
            st.L[-1].T, y[-1], lower=False)
        _, xs = jax.lax.scan(bwd, x_last, (st.L[:-1], st.M[1:], y[:-1]),
                             reverse=True)
        return jnp.concatenate([xs, x_last[None]])

    def _base_solve(self, st, xi_p, xi_d):
        if isinstance(st, DenseK1State):
            return self._dense()._base_solve(st, xi_p, xi_d)
        if isinstance(st, SparseK1LevelState):
            return self._level(self.min_block)._base_solve(st, xi_p, xi_d)
        d = st.d
        rhs_b = _to_blocked(st, xi_p) + jnp.einsum(
            "bij,j->bi", st.Ap, d * xi_d)
        y_b = self._band_solve_K(st, rhs_b)
        dy = _from_blocked(st, y_b)
        dx = d * (jnp.einsum("bij,bi->j", st.Ap, y_b) - xi_d)
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        if isinstance(state, SparseK1LevelState):
            return self._level(self.min_block).solve(state, xi_p, xi_d)
        st = state
        dx, dy = self._base_solve(st, xi_p, xi_d)
        regD_unperm = _from_blocked(st, st.regD)
        for _ in range(self.refinement_steps):
            Adx = _from_blocked(st, jnp.einsum("bij,j->bi", st.Ap, dx))
            ATdy = jnp.einsum("bij,bi->j", st.Ap, _to_blocked(st, dy))
            rp = xi_p - (Adx + regD_unperm * dy)
            rd = xi_d - (-(st.theta_reg * dx) + ATdy)
            ddx, ddy = self._base_solve(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

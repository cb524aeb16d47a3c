"""Tiled sparse K2 (augmented system) backend: host symbolic analysis +
dense-tile block LDLᵀ of the quasi-definite matrix.

This is the structured equivalent of the reference's workhorse sparse
backend — CHOLMOD LDLᵀ on the augmented system (reference:
src/KKT/Cholmod/sqd.jl:42-53, default Float64 dispatch
src/KKT/KKT.jl:134-141). K2 is what survives **dense columns** in A: a
dense column densifies K1 = AΘAᵀ completely, but in K2 it is a single
dense row/column that a dense-last ordering confines to the trailing
block, and κ(K2) = √κ(K1) helps near convergence.

Re-designed for dense tiles rather than translated:

- HOST (symbolic, at ``setup``): build the pattern of
  K2 = [[-Θ-Rp, Aᵀ], [A, Rd]] over N = n+m nodes; nodes whose degree
  marks them dense are ordered LAST (the CHOLMOD-style dense-row
  deferral), the remainder is RCM-ordered; the permuted pattern is cut
  into (B, B) tiles and run through the shared tile-granular symbolic
  elimination (kkt/sparse.py:symbolic_schedule), emitting a STATIC
  per-block-column schedule.
- DEVICE (numeric, at ``update``): one ``lax.fori_loop`` over block
  columns computing a **signed blocked Cholesky** K2 = 𝓛 Σ 𝓛ᵀ with
  Σ = diag(−1 on x nodes, +1 on y nodes): quasi-definiteness makes every
  Schur-complement diagonal block quasi-definite under ANY symmetric
  permutation (Vanderbei 1995), so with each tile's lanes sorted x-first
  the pivot tile factors branchlessly as ``U diag(σ) Uᵀ`` with U lower
  triangular — two masked (B, B) Choleskys (of the SPD x-part and of its
  SPD y-side Schur complement) plus one triangular solve, all
  backward-stable; NO explicit pivot-block inverses (an earlier design
  used ``inv(D_j)`` and its κ(block)·eps forward error stalled real IPM
  trajectories at ~1e-4 gaps). Subdiagonal L tiles come from batched
  TRSMs (or GEMMs against the per-tile triangular inverse U_j⁻¹ when
  ``inv_factor=True``, the default),
  right-looking ``-L_a Σ L_bᵀ`` updates from batched GEMMs. Tile
  ASSEMBLY is free: the off-diagonal A-values of every tile are
  precomputed at ``setup`` (they never change across IPM iterations),
  so each ``update`` starts with one vectorized rescale of the constant
  tile store instead of a serialized gather loop.
- ``solve`` is blocked forward substitution (triangular solve or
  U_j⁻¹ GEMV per block), a sign flip Σ, and blocked backward
  substitution, followed by the shared iterative-refinement sweeps on
  the true augmented system.

Falls back to the dense K2 backend when tiling gives no advantage.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import KKTBackend
from .dense_ldl import DenseK2Backend, DenseK2State
from .levels import (LevelSeg, build_level_plan, level_bwd,
                     level_factor_signed, level_fwd, nd_block_order,
                     tile_fill)
from .sparse import symbolic_schedule


def dense_threshold(dim: int) -> float:
    """A column of A with >= this many nonzeros (out of ``dim``) counts as
    dense: it produces a ~nnz² clique of fill under elimination, which at
    40% of the dimension stops being 'sparse plus exceptions'."""
    return max(32.0, 0.4 * dim)


def _k2_pattern_perm(A_np: np.ndarray):
    """Shared host symbolic front end: K2 pattern + dense-last RCM node
    permutation. Returns (K2 csr pattern, perm0, N, n_dense)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = A_np.shape
    N = n + m
    Apat = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    K2 = sp.bmat(
        [[sp.eye(n, dtype=np.int32, format="csr"), Apat.T],
         [Apat, sp.eye(m, dtype=np.int32, format="csr")]],
        format="csr")

    # Dense-node deferral: a column (row) of A touching a large fraction
    # of its dimension would explode RCM bandwidth and tile fill; order
    # such nodes last so their fill stays in the trailing block columns
    # (the CHOLMOD dense-row deferral, re-cast at node granularity).
    colnnz = Apat.getnnz(axis=0)
    rownnz = Apat.getnnz(axis=1)
    dense_x = np.flatnonzero(colnnz >= dense_threshold(m))
    dense_y = n + np.flatnonzero(rownnz >= dense_threshold(n))
    dense_nodes = np.concatenate([dense_x, dense_y])
    if len(dense_nodes) > 0.1 * N:
        dense_nodes = np.empty(0, np.int64)
    sparse_nodes = np.setdiff1d(np.arange(N), dense_nodes,
                                assume_unique=True)
    sub = K2[sparse_nodes][:, sparse_nodes].tocsr()
    psub = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True))
    perm = np.concatenate([sparse_nodes[psub],
                           dense_nodes]).astype(np.int64)
    return K2, perm, N, len(dense_nodes)


def k2_tile_plan(A_np: np.ndarray, block: int, gate: float = 0.5):
    """Host symbolic phase for the augmented system (column schedule).

    Returns None if tiling gives no advantage, else a dict with the node
    permutation (dense-degree nodes last, RCM on the rest) and the padded
    static tile schedule."""
    m, n = A_np.shape
    K2, perm, N, _ = _k2_pattern_perm(A_np)

    # Within-tile x-first sort: reorder each B-lane tile so x nodes
    # (< n, pivot sign −1) precede y nodes (sign +1). Tile membership —
    # hence the tile-granular pattern and schedule — is unchanged, but
    # every pivot tile becomes [[−P, Bᵀ], [B, Q]] with a STATIC sign
    # split, which is what lets the signed blocked Cholesky below use
    # masked SPD Choleskys instead of explicit quasi-definite inverses.
    for j0 in range(0, N, block):
        tile = perm[j0:j0 + block]
        perm[j0:j0 + block] = tile[np.argsort(tile >= n, kind="stable")]

    nbr = -(-N // block)
    Kp = K2[perm][:, perm].tocoo()
    sched = symbolic_schedule(Kp.row // block, Kp.col // block, nbr, gate)
    if sched is None:
        return None
    sched["perm"] = perm
    sched["N"] = N
    return sched


def k2_level_plan(A_np: np.ndarray, block: int, gate: float = 0.5):
    """Host symbolic phase for the LEVEL-SCHEDULED augmented system.

    Like :func:`k2_tile_plan` but the block rows are re-ordered by nested
    dissection over the tile graph (dense-node block rows forced last), so
    the numeric factorization runs in O(log nb) batched levels instead of
    nb sequential block-column steps (kkt/levels.py).

    Returns None if tiling gives no advantage, else
    (nodes_np (nbr, B), LevelPlan, N).
    """
    m, n = A_np.shape
    B = block
    K2, perm0, N, n_dense = _k2_pattern_perm(A_np)
    nbr = -(-N // B)
    if nbr <= 2:
        return None

    # Lane layout in perm0 block order; padding lanes get unique ids >= N.
    ext_len = nbr * B
    node_ids = np.concatenate(
        [perm0, N + np.arange(ext_len - N)]).astype(np.int32)
    nodes0 = node_ids.reshape(nbr, B)

    # Tile pattern in perm0 block coordinates.
    Kp = K2[perm0][:, perm0].tocoo()
    bi0 = Kp.row // B
    bj0 = Kp.col // B
    # Dense nodes sit at the end of perm0: their block rows are forced to
    # eliminate last (the root separator in the level schedule).
    first_dense_block = (N - n_dense) // B if n_dense else nbr
    last_blocks = range(first_dense_block, nbr)
    order = nd_block_order(bi0, bj0, nbr, last=last_blocks)
    binv = np.empty(nbr, np.int64)
    binv[order] = np.arange(nbr)

    nodes_np = nodes0[order]
    # Within-tile x-first sort (see k2_tile_plan): padding ids >= N sort
    # with the y/+1 group, which is what their identity pivots need.
    for j in range(nbr):
        lane = nodes_np[j]
        nodes_np[j] = lane[np.argsort(lane >= n, kind="stable")]

    col_rows = tile_fill(binv[bi0], binv[bj0], nbr)
    ntiles = nbr + sum(len(c) for c in col_rows)
    if ntiles >= gate * (nbr * (nbr + 1) // 2):
        return None
    return nodes_np, build_level_plan(col_rows, nbr), N


class SparseK2LevelState(NamedTuple):
    """Level-scheduled variant of :class:`SparseK2State`: same tile store
    semantics, but the schedule is the exact per-level index arrays of
    :class:`~tulip_tpu.kkt.levels.LevelPlan` (no dummy tile, no padding)."""

    A: jnp.ndarray            # (m, n) original constraint matrix
    nodes: jnp.ndarray        # (nbr, B) int32 node id per lane (pad >= N)
    theta_reg: jnp.ndarray    # (n,)
    regD: jnp.ndarray         # (m,)
    scale: jnp.ndarray        # (nbr*B,) Jacobi scale per node id
    T: jnp.ndarray            # (ntiles, B, B) tile store
    T0: jnp.ndarray           # (ntiles, B, B) constant off-diag K2 tiles
    tile_brow: jnp.ndarray    # (ntiles,)
    tile_bcol: jnp.ndarray    # (ntiles,)
    segs: tuple               # Tuple[LevelSeg, ...]


class SparseK2State(NamedTuple):
    """Static tile schedule + numeric factors for the permuted K2.

    ``T`` holds all (B, B) tiles of the filled lower-triangular pattern
    plus one trailing dummy tile absorbing masked scatter traffic. After
    ``update``, diagonal tiles hold the lower-triangular signed-Cholesky
    pivot factors U_j (K2 = 𝓛 Σ 𝓛ᵀ, Σ read off ``nodes`` signs) and
    subdiagonal tiles hold the L blocks.
    """

    A: jnp.ndarray            # (m, n) original constraint matrix
    nodes: jnp.ndarray        # (nbr+1, B) int32 node id per lane (pad >= N)
    theta_reg: jnp.ndarray    # (n,)  Θ⁻¹ + Rp
    regD: jnp.ndarray         # (m,)
    scale: jnp.ndarray        # (ext_len,) Jacobi scale per node id
    T: jnp.ndarray            # (ntiles+1, B, B) tile store
    T0: jnp.ndarray           # (ntiles+1, B, B) constant off-diag K2 tiles
    tile_brow: jnp.ndarray    # (ntiles+1,) block row of each tile
    tile_bcol: jnp.ndarray    # (ntiles+1,) block col of each tile
    col_ids: jnp.ndarray      # (nbr, cmax) subdiag tile ids (dummy-padded)
    col_blkrows: jnp.ndarray  # (nbr, cmax) block-row index (nbr = dummy)
    u_a: jnp.ndarray          # (nbr, umax) source position a in col list
    u_b: jnp.ndarray          # (nbr, umax) source position b
    u_tgt: jnp.ndarray        # (nbr, umax) target tile id (dummy-padded)


@dataclasses.dataclass(frozen=True)
class SparseK2Backend(KKTBackend):
    """K2 via dense-last + RCM ordered tile-granular block LDLᵀ."""

    name = "sparse-ldl"
    systems = ("K2",)
    block: int = 64
    jacobi_scale: bool = True
    # "column" (DEFAULT): the RCM-ordered fori_loop over block columns.
    # "level": nested-dissection block ordering + elimination-level batched
    # execution (kkt/levels.py). Level stays opt-in for K2: the signed
    # (quasi-definite) factorization is only norm-stable along orderings
    # with local Schur complements — measured on the m=2048 staircase, the
    # ND order loses ~4 decimal digits vs RCM (augmented residual 1e-7 vs
    # 6e-14 in f64) and overflows f32 at m=8192, because separator Schur
    # complements accumulate mixed-sign growth that the chain order keeps
    # local. SPD K1 (kkt/sparse.py) has no such issue — Cholesky is
    # permutation-stable — which is why level IS its default.
    schedule: str = "column"
    # Store U_j⁻¹ (triangular inverse, ONE extra TRSM per block column)
    # and run the per-column L-tile formation and the fwd/bwd solves as
    # GEMMs instead of batched TRSMs (many small TRSMs run far below
    # GEMM rates). Unlike the abandoned pivot-block inverses (κ(D)·eps), the triangular factor
    # has κ(U) = √κ(D), and the shared refinement sweeps restore the
    # rest: end-to-end accuracy is unchanged (tests cover both modes).
    inv_factor: bool = True
    # Validated end-to-end: the signed blocked Cholesky (masked SPD
    # Choleskys + TRSMs per pivot tile, no explicit inverses) solves
    # dense-column LPs to 1e-8 through full HSD/MPC trajectories with 2
    # refinement sweeps. An earlier design used explicit pivot-block
    # inverses whose κ(block)·eps forward error stalled at ~1e-4 gaps;
    # the default dense-column auto-probe path remains kkt/splitting.py
    # (SMW over all-SPD tiled K1 Cholesky pieces), which benches faster.

    def _dense(self) -> DenseK2Backend:
        return DenseK2Backend(refinement_steps=self.refinement_steps)

    def arithmetic(self, state) -> str:
        return str(state.A.dtype)

    def linear_system(self) -> str:
        return "Augmented system (K2), tiled block LDL^T"

    # -- host symbolic ----------------------------------------------------
    def setup(self, A: jnp.ndarray):
        A_np = np.asarray(A)
        m, n = A_np.shape
        if self.schedule == "level":
            lv = k2_level_plan(A_np, self.block)
            if lv is not None:
                return self._setup_level(A, A_np, lv)
            # fall through to the column schedule
        plan = k2_tile_plan(A_np, self.block)
        if plan is None:
            return self._dense().setup(A)
        B = self.block
        nbr = plan["nbr"]
        N = plan["N"]
        dt = A.dtype
        # Unique node ids for every lane incl. padding and the dummy
        # block row (row nbr): padding ids N, N+1, ... keep diagonal
        # detection (node_r == node_c) exact per lane.
        ext_len = (nbr + 1) * B
        node_ids = np.concatenate(
            [plan["perm"], N + np.arange(ext_len - N)]).astype(np.int32)
        nodes_np = node_ids.reshape(nbr + 1, B)

        # Precompute the CONSTANT off-diagonal K2 tile values once, host
        # side: the A entries never change across IPM iterations — only
        # the Jacobi scaling and the diagonal do — so ``update`` becomes
        # one vectorized rescale instead of a serialized per-block-column
        # gather loop of random-access gathers from the dense A.
        ntiles = plan["ntiles"]
        tile_brow = np.full(ntiles + 1, nbr, np.int32)
        tile_bcol = np.full(ntiles + 1, nbr, np.int32)
        for j in range(nbr):
            tile_brow[j] = tile_bcol[j] = j
            for p in range(plan["cmax"]):
                tid = int(plan["col_ids"][j, p])
                if tid < ntiles:
                    tile_brow[tid] = plan["col_blkrows"][j, p]
                    tile_bcol[tid] = j

        Aext = np.zeros((m + 1, n + 1), A_np.dtype)
        Aext[:m, :n] = A_np

        def off_vals(rn, cn):
            r_y = (rn >= n) & (rn < N)
            r_x = rn < n
            c_y = (cn >= n) & (cn < N)
            c_x = cn < n
            ar = np.where(r_y, rn - n, m)
            ac = np.where(c_x, cn, n)
            v_yx = Aext[ar[:, None], ac[None, :]]
            ar2 = np.where(c_y, cn - n, m)
            ac2 = np.where(r_x, rn, n)
            v_xy = Aext[ar2[None, :], ac2[:, None]]
            return (np.where(r_y[:, None] & c_x[None, :], v_yx, 0.0)
                    + np.where(r_x[:, None] & c_y[None, :], v_xy, 0.0))

        T0 = np.zeros((ntiles + 1, B, B), A_np.dtype)
        for t in range(ntiles):
            T0[t] = off_vals(nodes_np[tile_brow[t]], nodes_np[tile_bcol[t]])

        return SparseK2State(
            A=A,
            nodes=jnp.asarray(nodes_np),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones(m, dt),
            scale=jnp.ones(ext_len, dt),
            T=jnp.zeros((ntiles + 1, B, B), dt),
            T0=jnp.asarray(T0.astype(A_np.dtype)),
            tile_brow=jnp.asarray(tile_brow),
            tile_bcol=jnp.asarray(tile_bcol),
            col_ids=jnp.asarray(plan["col_ids"]),
            col_blkrows=jnp.asarray(plan["col_blkrows"]),
            u_a=jnp.asarray(plan["u_a"]),
            u_b=jnp.asarray(plan["u_b"]),
            u_tgt=jnp.asarray(plan["u_tgt"]),
        )

    def _setup_level(self, A, A_np, lv):
        """State construction for the level schedule: same constant-tile
        (T0) precompute as the column path, exact tile lists."""
        m, n = A_np.shape
        nodes_np, plan, N = lv
        nbr, B = nodes_np.shape
        dt = A.dtype
        ntiles = plan.ntiles

        Aext = np.zeros((m + 1, n + 1), A_np.dtype)
        Aext[:m, :n] = A_np

        def off_vals(rn, cn):
            r_y = (rn >= n) & (rn < N)
            r_x = rn < n
            c_y = (cn >= n) & (cn < N)
            c_x = cn < n
            ar = np.where(r_y, rn - n, m)
            ac = np.where(c_x, cn, n)
            v_yx = Aext[ar[:, None], ac[None, :]]
            ar2 = np.where(c_y, cn - n, m)
            ac2 = np.where(r_x, rn, n)
            v_xy = Aext[ar2[None, :], ac2[:, None]]
            return (np.where(r_y[:, None] & c_x[None, :], v_yx, 0.0)
                    + np.where(r_x[:, None] & c_y[None, :], v_xy, 0.0))

        T0 = np.zeros((ntiles, B, B), A_np.dtype)
        for t in range(ntiles):
            T0[t] = off_vals(nodes_np[plan.tile_brow[t]],
                             nodes_np[plan.tile_bcol[t]])

        return SparseK2LevelState(
            A=A,
            nodes=jnp.asarray(nodes_np),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones(m, dt),
            scale=jnp.ones(nbr * B, dt),
            T=jnp.zeros((ntiles, B, B), dt),
            T0=jnp.asarray(T0.astype(A_np.dtype)),
            tile_brow=jnp.asarray(plan.tile_brow),
            tile_bcol=jnp.asarray(plan.tile_bcol),
            segs=plan.segs,
        )

    # -- device numeric ---------------------------------------------------
    def _scale_diag(self, st, theta_inv, regP, regD, n, m, ext_len, dt):
        """Jacobi scale + diagonal value vectors, indexed by node id."""
        theta_reg = theta_inv + regP
        N = n + m
        if self.jacobi_scale:
            scale = jnp.concatenate(
                [1.0 / jnp.sqrt(theta_reg), 1.0 / jnp.sqrt(regD),
                 jnp.ones(ext_len - N, dt)])
            diagval = jnp.concatenate(
                [jnp.full(n, -1.0, dt), jnp.ones(ext_len - n, dt)])
        else:
            scale = jnp.ones(ext_len, dt)
            diagval = jnp.concatenate(
                [-theta_reg, regD, jnp.ones(ext_len - N, dt)])
        return theta_reg, scale, diagval

    def _update_level(self, st: SparseK2LevelState, theta_inv, regP, regD):
        m, n = st.A.shape
        nbr, B = st.nodes.shape
        dt = st.A.dtype
        theta_reg, scale, diagval = self._scale_diag(
            st, theta_inv, regP, regD, n, m, nbr * B, dt)

        # Assemble: rescale the constant tiles + set the diagonal (one
        # vectorized pass, identical to the column path).
        Srow = scale[st.nodes[st.tile_brow]]          # (ntiles, B)
        Scol = scale[st.nodes[st.tile_bcol]]
        T = st.T0 * Srow[:, :, None] * Scol[:, None, :]
        eye = jnp.eye(B, dtype=dt)
        dg = diagval[st.nodes]                        # (nbr, B)
        T = T.at[:nbr].add(eye[None, :, :] * dg[:, :, None])

        sgn = jnp.where(st.nodes < n, -1.0, 1.0).astype(dt)   # (nbr, B)
        T, ok = level_factor_signed(T, st.segs, lambda cols: sgn[cols],
                                    inv_factor=self.inv_factor)
        new = st._replace(theta_reg=theta_reg, regD=regD, scale=scale, T=T)
        return new, ok

    def _base_solve_level(self, st: SparseK2LevelState, xi_p, xi_d):
        m, n = st.A.shape
        N = n + m
        nbr, B = st.nodes.shape
        dt = st.A.dtype
        ext_len = nbr * B
        rhs_ext = (jnp.zeros(ext_len, dt).at[:n].set(xi_d)
                   .at[n:N].set(xi_p)) * st.scale
        rhs_b = rhs_ext[st.nodes]                     # (nbr, B)
        sgn = jnp.where(st.nodes < n, -1.0, 1.0).astype(dt)

        u = level_fwd(st.T, st.segs, rhs_b, inv_factor=self.inv_factor)
        v = u * sgn                                   # Σ⁻¹ = Σ
        x = level_bwd(st.T, st.segs, v, inv_factor=self.inv_factor)
        sol_ext = jnp.zeros(ext_len, dt).at[
            st.nodes.ravel()].set(x.ravel()) * st.scale
        return sol_ext[:n], sol_ext[n:N]

    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK2State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK2LevelState):
            return self._update_level(state, theta_inv, regP, regD)
        st = state
        m, n = st.A.shape
        N = n + m
        nbr = st.nodes.shape[0] - 1
        B = self.block
        ntiles_p1 = st.T.shape[0]
        dt = st.A.dtype
        theta_reg = theta_inv + regP

        # Symmetric Jacobi scaling: factor S K2 S with S = |diag(K2)|^-½,
        # whose diagonal is exactly ±1 — the standard stabilizer for
        # unpivoted quasi-definite LDLᵀ under the extreme diagonal spreads
        # of late IPM iterations (Θ⁻¹ entries 1e-10..1e10).
        ext_len = (nbr + 1) * B
        if self.jacobi_scale:
            scale = jnp.concatenate(
                [1.0 / jnp.sqrt(theta_reg), 1.0 / jnp.sqrt(regD),
                 jnp.ones(ext_len - N, dt)])
            # Scaled diagonal: -1 on x nodes, +1 on y nodes and padding
            # lanes (keeps padded pivots regular).
            diagval = jnp.concatenate(
                [jnp.full(n, -1.0, dt), jnp.ones(ext_len - n, dt)])
        else:
            scale = jnp.ones(ext_len, dt)
            diagval = jnp.concatenate(
                [-theta_reg, regD, jnp.ones(ext_len - N, dt)])

        # ---- assemble: rescale the constant tiles + set the diagonal ----
        # T0 holds the A-part of every tile (constant across iterations);
        # the scaled tile is T0 ∘ (scale_row ⊗ scale_col) plus the ±1 (or
        # unscaled ±θ/Rd) diagonal — one vectorized pass over all tiles.
        Srow = scale[st.nodes[st.tile_brow]]          # (ntiles+1, B)
        Scol = scale[st.nodes[st.tile_bcol]]
        T = st.T0 * Srow[:, :, None] * Scol[:, None, :]
        eye = jnp.eye(B, dtype=dt)
        dg = diagval[st.nodes[:nbr]]                  # (nbr, B)
        T = T.at[:nbr].add(eye[None, :, :] * dg[:, :, None])

        # ---- right-looking signed blocked Cholesky ----------------------
        # K2 = 𝓛 Σ 𝓛ᵀ with Σ = diag(σ), σ = −1 on x lanes, +1 on y and
        # padding lanes. With x-first in-tile ordering every pivot tile is
        # [[−P, Bᵀ], [B, Q]] whose signed factor U = [[Lp, 0], [−W, Ls]]
        # (P = Lp Lpᵀ, W = B Lp⁻ᵀ, Q + W Wᵀ = Ls Lsᵀ) is computed with two
        # masked SPD Choleskys + one TRSM — backward-stable primitives
        # only; quasi-definiteness keeps both masked blocks SPD at every
        # elimination step for ANY symmetric permutation (Vanderbei 1995).
        sgn = jnp.where(st.nodes < n, -1.0, 1.0).astype(dt)   # (nbr+1, B)

        def factor(j, carry):
            T, ok = carry
            ids = st.col_ids[j]
            valid = (ids < ntiles_p1 - 1)[:, None, None]
            s = sgn[j]                                # (B,)
            mx = (s < 0).astype(dt)                   # x lanes (first)
            my = 1.0 - mx
            Dj = T[j]
            Px = (-Dj) * (mx[:, None] * mx[None, :]) + jnp.diag(my)
            Lp = jnp.linalg.cholesky(Px)              # diag(Lp, I)
            Bm = Dj * (my[:, None] * mx[None, :])     # (2,1) block embedded
            W = jax.scipy.linalg.solve_triangular(
                Lp, Bm.T, lower=True).T               # y×x support
            Sy = Dj * (my[:, None] * my[None, :]) + W @ W.T + jnp.diag(mx)
            Ls = jnp.linalg.cholesky(Sy)              # diag(I, Ls)
            U = (Lp * (mx[:, None] * mx[None, :]) - W
                 + Ls * (my[:, None] * my[None, :]))
            ok_j = jnp.all(jnp.isfinite(U))
            U = jnp.where(ok_j, U, eye)
            Sub = T[ids]                              # (cmax, B, B)
            if self.inv_factor:
                # One TRSM for U_j⁻¹, then L tiles and solves are GEMMs.
                Uinv = jax.scipy.linalg.solve_triangular(U, eye,
                                                         lower=True)
                ok_j = ok_j & jnp.all(jnp.isfinite(Uinv))
                Uinv = jnp.where(ok_j, Uinv, eye)
                Y = jnp.einsum("ubc,dc->ubd", Sub, Uinv)
                diag_store = Uinv
            else:
                # L_ij = K_ij U_j⁻ᵀ Σ_j (batched TRSM + column sign flip).
                Y = jax.scipy.linalg.solve_triangular(
                    jnp.broadcast_to(U, Sub.shape), Sub.transpose(0, 2, 1),
                    lower=True).transpose(0, 2, 1)
                diag_store = U
            Lsub = jnp.where(valid & ok_j, Y * s[None, None, :], 0.0)
            T = T.at[j].set(diag_store)
            T = T.at[ids].set(jnp.where(valid, Lsub, T[ids]))
            # Right-looking updates: T[tgt] -= L_a Σ_j L_bᵀ.
            La = Lsub[st.u_a[j]] * s[None, None, :]   # (umax, B, B)
            Lb = Lsub[st.u_b[j]]
            upd = -jnp.einsum("ubc,udc->ubd", La, Lb)
            T = T.at[st.u_tgt[j]].add(upd)            # dummy absorbs pads
            return T, ok & ok_j

        T, ok = jax.lax.fori_loop(0, nbr, factor, (T, jnp.asarray(True)))
        new = SparseK2State(A=st.A, nodes=st.nodes, theta_reg=theta_reg,
                            regD=regD, scale=scale, T=T, T0=st.T0,
                            tile_brow=st.tile_brow, tile_bcol=st.tile_bcol,
                            col_ids=st.col_ids, col_blkrows=st.col_blkrows,
                            u_a=st.u_a, u_b=st.u_b, u_tgt=st.u_tgt)
        return new, ok

    # -- solve ------------------------------------------------------------
    def _base_solve(self, st, xi_p, xi_d):
        if isinstance(st, SparseK2LevelState):
            return self._base_solve_level(st, xi_p, xi_d)
        return self._base_solve_column(st, xi_p, xi_d)

    def _base_solve_column(self, st: SparseK2State, xi_p, xi_d):
        m, n = st.A.shape
        N = n + m
        nbr = st.nodes.shape[0] - 1
        B = st.nodes.shape[1]
        dt = st.A.dtype
        ext_len = (nbr + 1) * B
        # Scaled system: (S K2 S)(S⁻¹ sol) = S rhs.
        rhs_ext = (jnp.zeros(ext_len, dt).at[:n].set(xi_d)
                   .at[n:N].set(xi_p)) * st.scale
        rhs_b = rhs_ext[st.nodes]                     # (nbr+1, B)
        sgn = jnp.where(st.nodes < n, -1.0, 1.0).astype(dt)

        # Forward: 𝓛 u = rhs (diagonal tiles hold U_j, or U_j⁻¹ when
        # inv_factor; u_j is final once its block column is reached).
        def fwd(j, u):
            if self.inv_factor:
                uj = st.T[j] @ u[j]
            else:
                uj = jax.scipy.linalg.solve_triangular(st.T[j], u[j],
                                                       lower=True)
            u = u.at[j].set(uj)
            contrib = jnp.einsum("ubc,c->ub", st.T[st.col_ids[j]], uj)
            return u.at[st.col_blkrows[j]].add(-contrib)

        u = jax.lax.fori_loop(0, nbr, fwd, rhs_b)
        # Σ⁻¹ = Σ: flip signs on x lanes.
        v = u[:nbr] * sgn[:nbr]

        # Backward: 𝓛ᵀ x = v.
        def bwd(t, x):
            j = nbr - 1 - t
            xg = x[st.col_blkrows[j]]                 # (cmax, B)
            acc = jnp.einsum("ubc,ub->c", st.T[st.col_ids[j]], xg)
            if self.inv_factor:
                xj = st.T[j].T @ (v[j] - acc)
            else:
                xj = jax.scipy.linalg.solve_triangular(
                    st.T[j].T, v[j] - acc, lower=False)
            return x.at[j].set(xj)

        x = jax.lax.fori_loop(0, nbr, bwd, jnp.zeros((nbr + 1, B), dt))
        sol_ext = jnp.zeros(ext_len, dt).at[
            st.nodes[:nbr].ravel()].set(x[:nbr].ravel()) * st.scale
        return sol_ext[:n], sol_ext[n:N]

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK2State):
            return self._dense().solve(state, xi_p, xi_d)
        dx, dy = self._base_solve(state, xi_p, xi_d)
        return self._refine(state, xi_p, xi_d, dx, dy, self._base_solve)

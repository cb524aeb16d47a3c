"""Tiled sparse K1 backend: host symbolic analysis + dense-tile sparse
Cholesky.

This is the general-sparsity half of SURVEY §7 M4 (the banded backend
covers the band/staircase special case). CHOLMOD's supernodal design — a
scalar elimination tree with dense frontal matrices — is re-thought for
dense batched tile operations instead of translated:

- HOST (symbolic, at ``setup``; the role of CHOLMOD's ``analyze``,
  reference: src/KKT/Cholmod/spd.jl:30-38): RCM-order the K = A Aᵀ
  pattern, cut the permuted matrix into a grid of (B, B) tiles, run
  symbolic elimination AT TILE GRANULARITY (each fill "entry" is a whole
  tile), and emit a STATIC schedule: per block column, the list of
  subdiagonal tiles and the list of right-looking outer-product updates
  (source-pair positions + target tile id), padded to fixed widths.
- DEVICE (numeric, at ``update``): one ``lax.fori_loop`` over block
  columns; each step is a dense (B, B) Cholesky + one batched TRSM over
  the column's tiles + one batched GEMM scatter-add for its updates —
  all dense tile ops, no scalar sparse ops anywhere. ``solve`` runs blocked
  forward/backward substitution over the same tile lists.

Storage and flops scale with the number of structurally-nonzero tiles
after fill (O(ntiles·B³) factorization) instead of O(m³); like CHOLMOD,
the symbolic phase runs once and every IPM iteration reuses the plan.
Falls back to the dense inverse-factor backend when the filled pattern
has no sparsity advantage.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import KKTBackend
from .dense import DenseK1Backend, DenseK1State
from .levels import (build_level_plan, level_bwd, level_factor_spd,
                     level_fwd, nd_block_order, tile_fill)


def tile_plan(A_np: np.ndarray, block: int, use_native: bool = True):
    """Host symbolic phase. Returns None if tiling gives no advantage,
    else a dict with the permutation and the padded static schedule.

    Prefers the native C++ engine (native/symbolic.cpp — adjacency, RCM,
    tile-granular elimination and schedule emission in one call); the
    pure-Python/scipy implementation below is the reference semantics and
    the fallback."""
    if use_native:
        from .native import UNAVAILABLE, tile_plan_native
        plan = tile_plan_native(A_np, block)
        if plan is not UNAVAILABLE:
            return plan

    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = A_np.shape
    # int32 accumulator — int8 overflow can wrap counts to exactly 0 and
    # erase K-pattern entries (see rcm_bandwidth).
    pattern = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    Kpat = (pattern @ pattern.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))

    nbr = -(-m // block)
    # Tile-granular pattern of the permuted K (lower triangle).
    Kp = Kpat[perm][:, perm].tocoo()
    sched = symbolic_schedule(Kp.row // block, Kp.col // block, nbr)
    if sched is None:
        return None
    sched["perm"] = perm
    return sched


def symbolic_schedule(bi, bj, nbr, gate: float = 0.5):
    """Tile-granular symbolic elimination + static schedule emission.

    ``bi``/``bj`` are block coordinates of the nonzero entries of a
    (permuted) symmetric pattern; ``nbr`` the number of block rows. Shared
    by the K1 planner above and the K2 planner (kkt/sparse_ldl.py).
    Returns None when the filled tile count gives no sparsity advantage
    (>= ``gate`` of the dense lower-triangle tile count), else the padded
    static schedule dict (everything except the node permutation)."""
    cols = [set() for _ in range(nbr)]   # strictly-below block rows per col
    for i, j in zip(bi, bj):
        if i > j:
            cols[j].add(int(i))
        elif j > i:
            cols[i].add(int(j))
    # Symbolic elimination at tile granularity: eliminating column j turns
    # every pair (a, b) of its below-diagonal block rows into a tile of
    # column min(a, b) (right-looking fill).
    for j in range(nbr):
        rows = sorted(cols[j])
        for x in range(len(rows)):
            for y in range(x + 1, len(rows)):
                cols[rows[x]].add(rows[y])

    ntiles_sub = sum(len(c) for c in cols)
    ntiles = ntiles_sub + nbr            # + diagonal tiles
    dense_tiles = nbr * (nbr + 1) // 2
    if ntiles >= gate * dense_tiles or nbr <= 2:
        return None                      # no sparsity advantage

    # Assign tile ids: diagonal tiles first (id j for (j, j)), then
    # subdiagonal tiles column-major.
    tid = {}
    for j in range(nbr):
        tid[(j, j)] = j
    next_id = nbr
    col_rows = []
    for j in range(nbr):
        rows = sorted(cols[j])
        col_rows.append(rows)
        for i in rows:
            tid[(i, j)] = next_id
            next_id += 1

    cmax = max((len(r) for r in col_rows), default=0)
    cmax = max(cmax, 1)
    umax = max((len(r) * (len(r) + 1) // 2 for r in col_rows), default=0)
    umax = max(umax, 1)

    dummy = ntiles                       # masked gathers/scatters land here
    col_ids = np.full((nbr, cmax), dummy, np.int32)
    col_blkrows = np.full((nbr, cmax), nbr, np.int32)  # dummy block row
    u_a = np.zeros((nbr, umax), np.int32)     # position in col list
    u_b = np.zeros((nbr, umax), np.int32)
    u_tgt = np.full((nbr, umax), dummy, np.int32)
    for j in range(nbr):
        rows = col_rows[j]
        for p, i in enumerate(rows):
            col_ids[j, p] = tid[(i, j)]
            col_blkrows[j, p] = i
        q = 0
        for x in range(len(rows)):
            for y in range(x, len(rows)):
                a, b = rows[y], rows[x]          # a >= b
                u_a[j, q] = y
                u_b[j, q] = x
                u_tgt[j, q] = tid[(a, b)]
                q += 1
    return dict(nbr=nbr, ntiles=ntiles, cmax=cmax, umax=umax,
                col_ids=col_ids, col_blkrows=col_blkrows,
                u_a=u_a, u_b=u_b, u_tgt=u_tgt)


def k1_level_plan(A_np: np.ndarray, block: int, gate: float = 0.5,
                  use_native: bool = True):
    """Host symbolic phase for the LEVEL-SCHEDULED K1 backend.

    Like :func:`tile_plan` (scalar RCM on the K = A Aᵀ pattern) but the
    block rows are re-ordered by nested dissection over the tile graph so
    the numeric factorization runs in O(log nb) batched levels
    (kkt/levels.py) instead of nb sequential block-column steps.

    Also emits the per-block-row COLUMN SUPPORT of A (``sup_idx``), so
    tile assembly contracts each A_i D A_jᵀ tile over the owner column's
    support instead of all n columns (the assembly is where K1's flops
    live; the support is padded with ``n``, pointing at a zero column).

    Returns None if tiling (or the support compression) gives no
    advantage, else a dict.
    """
    import scipy.sparse as sp

    pattern = sp.csr_matrix((np.abs(A_np) > 0).astype(np.int32))
    return k1_level_plan_pattern(pattern, A_np.shape, block, gate)


def k1_level_plan_pattern(pattern, shape, block: int, gate: float = 0.5,
                          sup_cap: float = 0.5):
    """Pattern-only core of :func:`k1_level_plan`.

    ``pattern`` is a scipy CSR 0/1 matrix — the only input the symbolic
    phase needs, so the sparse-first LPData path (ipm/sparse_data.py) can
    plan in O(nnz) without ever materializing a dense (m, n) array.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m, n = shape
    B = block
    Kpat = (pattern @ pattern.T).tocsr()
    perm0 = np.asarray(reverse_cuthill_mckee(Kpat, symmetric_mode=True))
    nbr = -(-m // B)
    if nbr <= 2:
        return None

    Kp = Kpat[perm0][:, perm0].tocoo()
    bi0 = Kp.row // B
    bj0 = Kp.col // B
    # The partial final block (m % B != 0) must stay LAST: the composed
    # scalar permutation concatenates whole blocks, so a short block in
    # the middle would shift every later block boundary off the tile
    # coordinates (observed as numerically-nonzero K tiles missing from
    # the symbolic plan on a 2080-row block-angular LP).
    last_blocks = [nbr - 1] if m % B else []
    order = nd_block_order(bi0, bj0, nbr, last=last_blocks)
    binv = np.empty(nbr, np.int64)
    binv[order] = np.arange(nbr)

    # Composed scalar permutation: RCM rows regrouped in ND block order
    # (the last, possibly partial, RCM block keeps its identity).
    blocks0 = [perm0[k * B:(k + 1) * B] for k in range(nbr)]
    perm = np.concatenate([blocks0[b] for b in order]).astype(np.int64)

    col_rows = tile_fill(binv[bi0], binv[bj0], nbr)
    ntiles = nbr + sum(len(c) for c in col_rows)
    if ntiles >= gate * (nbr * (nbr + 1) // 2):
        return None
    plan = build_level_plan(col_rows, nbr)

    # Column support per (ND-ordered) block row of A.
    Aperm = pattern[perm]          # csr, rows in elimination order
    sups = []
    for j in range(nbr):
        rows = Aperm[j * B:min((j + 1) * B, m)]
        sups.append(np.unique(rows.indices))
    smax = max((len(s) for s in sups), default=1)
    smax = max(smax, 1)
    if smax > sup_cap * n:
        return None                # support compression gives no advantage
    sup_idx = np.full((nbr, smax), n, np.int32)
    for j, s in enumerate(sups):
        sup_idx[j, :len(s)] = s
    return dict(perm=perm, plan=plan, sup_idx=sup_idx)


class SparseK1LevelState(NamedTuple):
    """Level-scheduled variant of :class:`SparseK1State`.

    The dense (nbr, B, n) row-block store of the column path is GONE:
    every operand that touches A is precomputed in support-compressed
    form at setup (A's values never change across IPM iterations), so an
    ``update`` is one batched assembly einsum over constants + the level
    factorization, and matvecs contract over each block row's column
    support only."""

    Apc: jnp.ndarray          # (nbr, B, smax) support-compressed rows
    sup_idx: jnp.ndarray      # (nbr, smax) int32 column support (pad = n)
    Rg0: jnp.ndarray          # (ntiles, smax, B) row-side tile operand
    Oc0: jnp.ndarray          # (ntiles, B, smax) col-side tile operand
    sup_tile: jnp.ndarray     # (ntiles, smax) owner column's support per
                              # tile = sup_idx[tile_bcol], precomputed at
                              # setup instead of gathered in the update
    perm: jnp.ndarray         # (m,) int32
    d: jnp.ndarray            # (n,)
    theta_reg: jnp.ndarray    # (n,)
    regD: jnp.ndarray         # (nbr, B) permuted/padded (1.0 on padding)
    T: jnp.ndarray            # (ntiles, B, B) tile store
    segs: tuple               # Tuple[LevelSeg, ...]


class SparseK1State(NamedTuple):
    """Static tile schedule + numeric factors.

    ``T`` holds all (B, B) tiles of the filled lower-triangular pattern
    plus one trailing dummy tile absorbing masked scatter traffic. After
    ``update``, diagonal tiles hold their Cholesky factors and
    subdiagonal tiles hold L-blocks.
    """

    Ap: jnp.ndarray           # (nbr, B, n) permuted + padded blocked rows
    perm: jnp.ndarray         # (m,) int32
    d: jnp.ndarray            # (n,)
    theta_reg: jnp.ndarray    # (n,)
    regD: jnp.ndarray         # (nbr, B) permuted/padded (1.0 on padding)
    T: jnp.ndarray            # (ntiles+1, B, B) tile store
    col_ids: jnp.ndarray      # (nbr, cmax) subdiag tile ids (dummy-padded)
    col_blkrows: jnp.ndarray  # (nbr, cmax) block-row index (nbr = dummy)
    u_a: jnp.ndarray          # (nbr, umax) source position a in col list
    u_b: jnp.ndarray          # (nbr, umax) source position b
    u_tgt: jnp.ndarray        # (nbr, umax) target tile id (dummy-padded)


@dataclasses.dataclass(frozen=True)
class SparseK1Backend(KKTBackend):
    """K1 via RCM-ordered tile-granular sparse Cholesky."""

    name = "sparse"
    systems = ("K1",)
    block: int = 64
    # "level": nested-dissection block ordering + elimination-level batched
    # execution with support-compressed assembly (kkt/levels.py);
    # "column": the fori_loop over block columns.
    schedule: str = "level"
    # Store L_j⁻¹ per pivot tile and run L-tile formation and the fwd/bwd
    # solves as GEMMs instead of TRSMs; accuracy restored by
    # the shared refinement sweeps. Only used by the level schedule.
    inv_factor: bool = True

    def _dense(self) -> DenseK1Backend:
        return DenseK1Backend(inv_factor=True,
                              refinement_steps=self.refinement_steps)

    def arithmetic(self, state) -> str:
        return str(state.Ap.dtype
                   if isinstance(state, (SparseK1State, SparseK1LevelState))
                   else state.A.dtype)

    def linear_system(self) -> str:
        return "Normal equations (K1), tiled sparse Cholesky"

    # -- host symbolic ----------------------------------------------------
    def setup_data(self, dat):
        """Sparse-first LP data carries the symbolic plan and compressed
        blocks already — build the level state from them directly, never
        materializing dense A (ipm/sparse_data.py)."""
        from ..ipm.sparse_data import SparseLPData
        if isinstance(dat, SparseLPData):
            return self._setup_from_sparse_data(dat)
        return self.setup(dat.A)

    def _setup_from_sparse_data(self, dat):
        nbr, B, smax = dat.Apc.shape
        n = dat.c.shape[0]
        m = dat.perm.shape[0]
        dt = dat.Apc.dtype
        sup = np.asarray(dat.sup_idx)                 # (nbr, smax)
        tb = np.asarray(dat.tile_brow)
        tc = np.asarray(dat.tile_bcol)
        ntiles = tb.shape[0]

        # Host gather map: gmap[t, s] = position of column sup[tc[t], s]
        # inside block row tb[t]'s support, or smax (a zero pad column)
        # when absent. Each support row is sorted with trailing pads = n,
        # so searchsorted per tile is O(smax log smax).
        gmap = np.full((ntiles, smax), smax, np.int32)
        for t in range(ntiles):
            si = sup[tb[t]]
            sj = sup[tc[t]]
            pos = np.searchsorted(si, sj)
            pos_cl = np.minimum(pos, smax - 1)
            hit = (si[pos_cl] == sj) & (sj < n)
            gmap[t] = np.where(hit, pos_cl, smax)

        # Tile operands on device via one batched gather (no dense A):
        # Rg0[t, s, b] = A_{tb[t]}[b, sup(tc[t])[s]].
        Apc_ext = jnp.concatenate(
            [dat.Apc, jnp.zeros((nbr, B, 1), dt)], axis=2)
        Rg = jnp.take_along_axis(
            Apc_ext[jnp.asarray(tb)],
            jnp.asarray(gmap)[:, None, :], axis=2)    # (ntiles, B, smax)
        return SparseK1LevelState(
            Apc=dat.Apc,
            sup_idx=dat.sup_idx,
            Rg0=Rg.transpose(0, 2, 1),
            Oc0=dat.Apc[jnp.asarray(tc)],
            sup_tile=jnp.asarray(sup[tc]),
            perm=dat.perm,
            d=jnp.ones(n, dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones((nbr, B), dt),
            T=jnp.zeros((ntiles, B, B), dt),
            segs=dat.segs,
        )

    def setup(self, A: jnp.ndarray):
        A_np = np.asarray(A)
        m, n = A_np.shape
        if self.schedule == "level":
            lv = k1_level_plan(A_np, self.block)
            if lv is not None:
                return self._setup_level(A_np, lv)
            # ND fill can trip the gate where the RCM column plan does
            # not (small chains): fall through to the column schedule.
        plan = tile_plan(A_np, self.block)
        if plan is None:
            return self._dense().setup(A)
        B = self.block
        nbr = plan["nbr"]
        Ap = np.zeros((nbr * B, n), dtype=A_np.dtype)
        Ap[:m] = A_np[plan["perm"]]
        dt = A.dtype
        return SparseK1State(
            Ap=jnp.asarray(Ap.reshape(nbr, B, n)),
            perm=jnp.asarray(plan["perm"], jnp.int32),
            d=jnp.ones(n, dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones((nbr, B), dt),
            T=jnp.zeros((plan["ntiles"] + 1, B, B), dt),
            col_ids=jnp.asarray(plan["col_ids"]),
            col_blkrows=jnp.asarray(plan["col_blkrows"]),
            u_a=jnp.asarray(plan["u_a"]),
            u_b=jnp.asarray(plan["u_b"]),
            u_tgt=jnp.asarray(plan["u_tgt"]),
        )

    def _setup_level(self, A_np, lv):
        m, n = A_np.shape
        B = self.block
        plan = lv["plan"]
        perm = lv["perm"]
        sup_idx = lv["sup_idx"]
        nbr = -(-m // B)
        dt = jnp.asarray(A_np[:1, :1]).dtype
        Ap = np.zeros((nbr * B, n + 1), dtype=A_np.dtype)
        Ap[:m, :n] = A_np[perm]
        Ap = Ap.reshape(nbr, B, n + 1)
        # Support-compressed row blocks (pad column n reads as zero).
        Apc = np.take_along_axis(Ap, sup_idx[:, None, :], axis=2)
        # Constant per-tile assembly operands: tile (i, j) contracts
        # A_i[:, sup(j)] against A_j[:, sup(j)] — both never change.
        Rg0 = Ap[plan.tile_brow[:, None], :,
                 sup_idx[plan.tile_bcol]]            # (ntiles, smax, B)
        Oc0 = Apc[plan.tile_bcol]                    # (ntiles, B, smax)
        return SparseK1LevelState(
            Apc=jnp.asarray(Apc),
            sup_idx=jnp.asarray(sup_idx),
            Rg0=jnp.asarray(Rg0),
            Oc0=jnp.asarray(Oc0),
            sup_tile=jnp.asarray(sup_idx[plan.tile_bcol]),
            perm=jnp.asarray(perm, jnp.int32),
            d=jnp.ones(n, dt),
            theta_reg=jnp.ones(n, dt),
            regD=jnp.ones((nbr, B), dt),
            T=jnp.zeros((plan.ntiles, B, B), dt),
            segs=plan.segs,
        )

    # -- helpers ----------------------------------------------------------
    def _to_blocked(self, st, v):
        m = st.perm.shape[0]
        nbr, B = st.regD.shape
        return jnp.pad(v[st.perm], (0, nbr * B - m)).reshape(nbr, B)

    def _from_blocked(self, st, vb):
        m = st.perm.shape[0]
        flat = vb.reshape(-1)[:m]
        return jnp.zeros(m, vb.dtype).at[st.perm].set(flat)

    def _A_blocked(self, st: SparseK1LevelState, x):
        """A x per (permuted) block row via the compressed supports."""
        xs = jnp.concatenate([x, jnp.zeros(1, x.dtype)])[st.sup_idx]
        return jnp.einsum("bis,bs->bi", st.Apc, xs)

    def _AT_blocked(self, st: SparseK1LevelState, yb):
        """Aᵀ y for a blocked y via scatter-add over the supports."""
        n = st.d.shape[0]
        contrib = jnp.einsum("bis,bi->bs", st.Apc, yb)
        return jnp.zeros(n + 1, yb.dtype).at[
            st.sup_idx.ravel()].add(contrib.ravel())[:n]

    # -- device numeric ---------------------------------------------------
    def _update_level(self, st: SparseK1LevelState, theta_inv, regP, regD):
        nbr, B = st.regD.shape
        dt = st.Apc.dtype
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = self._to_blocked(st, regD)
        m = st.perm.shape[0]
        pad_mask = (jnp.arange(nbr * B) >= m).reshape(nbr, B)
        regDb = jnp.where(pad_mask, 1.0, regDb)

        # Support-compressed assembly of ALL tiles in one batched einsum
        # over the CONSTANT setup-time operands: tile (i, j) = A_i diag(d)
        # A_jᵀ contracted over column j's support only; just d changes.
        d_ext = jnp.concatenate([d, jnp.zeros(1, dt)])
        ds = d_ext[st.sup_tile]                       # (ntiles, smax)
        T = jnp.einsum("tsb,tcs,ts->tbc", st.Rg0, st.Oc0, ds)
        eye = jnp.eye(B, dtype=dt)
        T = T.at[:nbr].add(eye[None, :, :] * regDb[:, :, None])

        T, ok = level_factor_spd(T, st.segs, inv_factor=self.inv_factor)
        new = st._replace(d=d, theta_reg=theta_reg, regD=regDb, T=T)
        return new, ok

    def _solve_K_blocked(self, st, rhs_b):
        """(P K Pᵀ) y = rhs for a blocked rhs, either schedule."""
        if isinstance(st, SparseK1LevelState):
            u = level_fwd(st.T, st.segs, rhs_b, inv_factor=self.inv_factor)
            return level_bwd(st.T, st.segs, u, inv_factor=self.inv_factor)
        return self._tile_solve_K(st, rhs_b)

    def _base_solve_level(self, st: SparseK1LevelState, xi_p, xi_d):
        d = st.d
        rhs_b = self._to_blocked(st, xi_p) + self._A_blocked(st, d * xi_d)
        y_b = self._solve_K_blocked(st, rhs_b)
        dy = self._from_blocked(st, y_b)
        dx = d * (self._AT_blocked(st, y_b) - xi_d)
        return dx, dy

    def update(self, state, theta_inv, regP, regD):
        if isinstance(state, DenseK1State):
            return self._dense().update(state, theta_inv, regP, regD)
        if isinstance(state, SparseK1LevelState):
            return self._update_level(state, theta_inv, regP, regD)
        st = state
        nbr, B, n = st.Ap.shape
        ntiles_p1 = st.T.shape[0]
        dt = st.Ap.dtype
        theta_reg = theta_inv + regP
        d = 1.0 / theta_reg
        regDb = self._to_blocked(st, regD)
        m = st.perm.shape[0]
        pad_mask = (jnp.arange(nbr * B) >= m).reshape(nbr, B)
        regDb = jnp.where(pad_mask, 1.0, regDb)

        Ad = st.Ap * d[None, None, :]
        # Pad block-row gathers with a zero block at index nbr.
        Ap_g = jnp.concatenate([st.Ap, jnp.zeros((1, B, n), dt)])
        eye = jnp.eye(B, dtype=dt)

        # ---- assemble K tiles column by column (bounded memory) --------
        def assemble(j, T):
            ids = st.col_ids[j]                       # (cmax,)
            rows = st.col_blkrows[j]                  # (cmax,)
            Arows = Ap_g[rows]                        # (cmax, B, n)
            Kcol = jnp.einsum("ubj,cj->ubc", Arows, Ad[j])
            T = T.at[ids].set(Kcol)                   # dummy pad -> dummy
            Kdiag = st.Ap[j] @ Ad[j].T + jnp.diag(regDb[j])
            return T.at[j].set(Kdiag)

        T = jax.lax.fori_loop(0, nbr, assemble,
                              jnp.zeros((ntiles_p1, B, B), dt))

        # ---- right-looking tiled Cholesky -------------------------------
        def factor(j, carry):
            T, ok = carry
            ids = st.col_ids[j]
            valid = (ids < ntiles_p1 - 1)[:, None, None]
            D = T[j]
            Ld = jnp.linalg.cholesky(D)
            ok_j = jnp.all(jnp.isfinite(Ld))
            Ld = jnp.where(ok_j, Ld, eye)
            Sub = T[ids]                              # (cmax, B, B)
            # L_ij = T_ij Ld^-T  (batched TRSM).
            Lsub = jax.scipy.linalg.solve_triangular(
                jnp.broadcast_to(Ld, Sub.shape), Sub.transpose(0, 2, 1),
                lower=True).transpose(0, 2, 1)
            Lsub = jnp.where(valid & ok_j, Lsub, 0.0)
            T = T.at[j].set(Ld)
            T = T.at[ids].set(jnp.where(valid, Lsub, T[ids]))
            # Right-looking updates: T[tgt] -= L_a L_bᵀ.
            La = Lsub[st.u_a[j]]                      # (umax, B, B)
            Lb = Lsub[st.u_b[j]]
            upd = -jnp.einsum("ubc,udc->ubd", La, Lb)
            T = T.at[st.u_tgt[j]].add(upd)            # dummy absorbs pads
            return T, ok & ok_j

        T, ok = jax.lax.fori_loop(0, nbr, factor, (T, jnp.asarray(True)))
        new = SparseK1State(Ap=st.Ap, perm=st.perm, d=d,
                            theta_reg=theta_reg, regD=regDb, T=T,
                            col_ids=st.col_ids, col_blkrows=st.col_blkrows,
                            u_a=st.u_a, u_b=st.u_b, u_tgt=st.u_tgt)
        return new, ok

    def _tile_solve_K(self, st: SparseK1State, rhs_b):
        """(P K Pᵀ) y = rhs via blocked forward/backward substitution."""
        nbr, B, _ = st.Ap.shape

        def fwd(j, y):
            yj = jax.scipy.linalg.solve_triangular(st.T[j], y[j], lower=True)
            y = y.at[j].set(yj)
            contrib = jnp.einsum("ubc,c->ub", st.T[st.col_ids[j]], yj)
            return y.at[st.col_blkrows[j]].add(-contrib)  # dummy row nbr

        y = jax.lax.fori_loop(0, nbr, fwd,
                              jnp.concatenate([rhs_b,
                                               jnp.zeros((1, B),
                                                         rhs_b.dtype)]))

        def bwd(t, x):
            j = nbr - 1 - t
            xg = x[st.col_blkrows[j]]                 # (cmax, B)
            acc = jnp.einsum("ubc,ub->c", st.T[st.col_ids[j]], xg)
            xj = jax.scipy.linalg.solve_triangular(
                st.T[j].T, y[j] - acc, lower=False)
            return x.at[j].set(xj)

        x = jax.lax.fori_loop(0, nbr, bwd,
                              jnp.zeros((nbr + 1, B), rhs_b.dtype))
        return x[:nbr]

    def _base_solve(self, st, xi_p, xi_d):
        if isinstance(st, SparseK1LevelState):
            return self._base_solve_level(st, xi_p, xi_d)
        d = st.d
        rhs_b = self._to_blocked(st, xi_p) + jnp.einsum(
            "bij,j->bi", st.Ap, d * xi_d)
        y_b = self._tile_solve_K(st, rhs_b)
        dy = self._from_blocked(st, y_b)
        dx = d * (jnp.einsum("bij,bi->j", st.Ap, y_b) - xi_d)
        return dx, dy

    def _solve_level(self, st: SparseK1LevelState, xi_p, xi_d):
        dx, dy = self._base_solve_level(st, xi_p, xi_d)
        regD_unperm = self._from_blocked(st, st.regD)
        for _ in range(self.refinement_steps):
            Adx = self._from_blocked(st, self._A_blocked(st, dx))
            ATdy = self._AT_blocked(st, self._to_blocked(st, dy))
            rp = xi_p - (Adx + regD_unperm * dy)
            rd = xi_d - (-(st.theta_reg * dx) + ATdy)
            ddx, ddy = self._base_solve_level(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

    def solve(self, state, xi_p, xi_d):
        if isinstance(state, DenseK1State):
            return self._dense().solve(state, xi_p, xi_d)
        if isinstance(state, SparseK1LevelState):
            return self._solve_level(state, xi_p, xi_d)
        st = state
        dx, dy = self._base_solve(st, xi_p, xi_d)
        regD_unperm = self._from_blocked(st, st.regD)
        for _ in range(self.refinement_steps):
            Adx = self._from_blocked(
                st, jnp.einsum("bij,j->bi", st.Ap, dx))
            ATdy = jnp.einsum("bij,bi->j", st.Ap,
                              self._to_blocked(st, dy))
            rp = xi_p - (Adx + regD_unperm * dy)
            rd = xi_d - (-(st.theta_reg * dx) + ATdy)
            ddx, ddy = self._base_solve(st, rp, rd)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

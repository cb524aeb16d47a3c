"""Elimination-level scheduled execution for the tiled sparse backends.

The column schedule of the tiled backends (kkt/sparse.py,
kkt/sparse_ldl.py, kkt/banded.py) executes their static tile schedules as
a ``lax.fori_loop`` over block columns — one tiny (B, B) Cholesky + a
short batched TRSM/GEMM per step, which serializes hundreds of small ops
and leaves the device mostly idle. This module replaces the column-at-a-time execution with
the supernodal-parallelism analogue of CHOLMOD's elimination tree
(reference: src/KKT/Cholmod/spd.jl:30-49 symbolic/numeric split):

- HOST: order the *block rows* by nested dissection over the tile graph
  (recursive BFS bisection). RCM orderings produce elimination CHAINS
  (column j depends on j-1: zero parallelism); nested dissection produces
  a balanced elimination tree of depth O(log nb), so block columns group
  into ~2·log₂(nb) independent LEVELS.
- HOST: run tile-granular symbolic elimination on the ND-ordered pattern,
  compute each block column's elimination level, and emit per-level
  EXACT (unpadded) index arrays: the level's pivot columns, its
  subdiagonal tiles (with owner/block-row), and its right-looking
  outer-product updates.
- DEVICE: one unrolled pass over the ~2·log₂(nb) levels; each level is
  ONE batched Cholesky over all its pivot tiles, ONE batched TRSM (or
  triangular-inverse GEMM) over all its subdiagonal tiles, and ONE
  batched GEMM + scatter-add for all its updates. Forward/backward
  substitution runs over the same levels.

ND fill on a chain is ~1.5–2x the band fill (each leaf column gains its
enclosing separators as ancestors), but every op is a batched dense op and the
sequential depth drops from nb to log nb.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Host: nested dissection over the tile graph
# ---------------------------------------------------------------------------

def _components(adj: List[set], nodes: Sequence[int]) -> List[List[int]]:
    nodeset = set(nodes)
    seen = set()
    comps = []
    for s in nodes:
        if s in seen:
            continue
        comp, stack = [], [s]
        seen.add(s)
        while stack:
            v = stack.pop()
            comp.append(v)
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    stack.append(w)
        comps.append(comp)
    return comps


def _bfs_levels(adj: List[set], nodeset: set, root: int) -> List[List[int]]:
    levels = [[root]]
    seen = {root}
    while True:
        nxt = []
        for v in levels[-1]:
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            return levels
        levels.append(nxt)


def nd_block_order(bi: np.ndarray, bj: np.ndarray, nbr: int,
                   last: Sequence[int] = (), leaf: int = 2) -> np.ndarray:
    """Nested-dissection elimination order of block rows.

    ``bi``/``bj``: block coordinates of the (symmetric) tile pattern.
    ``last``: block rows forced to the end (dense-node deferral).
    Returns a permutation ``order`` with ``order[k]`` = old block row
    eliminated k-th.
    """
    adj: List[set] = [set() for _ in range(nbr)]
    for i, j in zip(np.asarray(bi), np.asarray(bj)):
        i, j = int(i), int(j)
        if i != j:
            adj[i].add(j)
            adj[j].add(i)
    lastset = set(int(x) for x in last)
    free = [v for v in range(nbr) if v not in lastset]

    def dissect(nodes: List[int]) -> List[int]:
        order: List[int] = []
        for comp in _components(adj, nodes):
            if len(comp) <= leaf:
                order.extend(sorted(comp))
                continue
            compset = set(comp)
            # Pseudo-peripheral start: two BFS sweeps.
            lv = _bfs_levels(adj, compset, comp[0])
            lv = _bfs_levels(adj, compset, lv[-1][0])
            if len(lv) <= 2:
                # No useful diameter (clique-ish): eliminate as one block.
                order.extend(sorted(comp))
                continue
            # Split at the median level; that level is the separator.
            sizes = np.cumsum([len(l) for l in lv])
            k = int(np.searchsorted(sizes, sizes[-1] // 2))
            k = min(max(k, 1), len(lv) - 2)
            sep = lv[k]
            a = [v for l in lv[:k] for v in l]
            b = [v for l in lv[k + 1:] for v in l]
            order.extend(dissect(a))
            order.extend(dissect(b))
            order.extend(sorted(sep))
        return order

    return np.asarray(dissect(free) + sorted(lastset), np.int64)


# ---------------------------------------------------------------------------
# Host: fill, levels, and per-level schedule emission
# ---------------------------------------------------------------------------

def tile_fill(bi, bj, nbr) -> List[List[int]]:
    """Tile-granular symbolic elimination (right-looking fill): returns the
    sorted strictly-below block rows of each block column after fill."""
    cols = [set() for _ in range(nbr)]
    for i, j in zip(bi, bj):
        if i > j:
            cols[j].add(int(i))
        elif j > i:
            cols[i].add(int(j))
    for j in range(nbr):
        rows = sorted(cols[j])
        for x in range(len(rows)):
            for y in range(x + 1, len(rows)):
                cols[rows[x]].add(rows[y])
    return [sorted(c) for c in cols]


def column_levels(col_rows: List[List[int]]) -> np.ndarray:
    """Elimination level of each block column: 0 for columns receiving no
    updates, else 1 + max level over the columns that update them."""
    nbr = len(col_rows)
    level = np.zeros(nbr, np.int64)
    for i in range(nbr):
        li = level[i] + 1
        for j in col_rows[i]:          # eliminating i updates column j
            if li > level[j]:
                level[j] = li
    return level


class LevelSeg(NamedTuple):
    """One elimination level's exact (unpadded) schedule. All arrays are
    device int32; zero-length levels are represented by empty arrays."""

    cols: jnp.ndarray        # (w,)  block columns (diag tile id == col id)
    sub_ids: jnp.ndarray     # (S,)  subdiagonal tile ids of these columns
    sub_owner: jnp.ndarray   # (S,)  index into ``cols``
    sub_brow: jnp.ndarray    # (S,)  block row of each subdiagonal tile
    u_a: jnp.ndarray         # (U,)  index into the level's sub arrays
    u_b: jnp.ndarray         # (U,)
    u_tgt: jnp.ndarray       # (U,)  target tile id


class LevelPlan(NamedTuple):
    ntiles: int
    tile_brow: np.ndarray    # (ntiles,)
    tile_bcol: np.ndarray    # (ntiles,)
    segs: Tuple[LevelSeg, ...]


def build_level_plan(col_rows: List[List[int]], nbr: int) -> LevelPlan:
    """Assign tile ids (diagonal first) and group block columns by
    elimination level, emitting exact per-level index arrays."""
    level = column_levels(col_rows)
    tid = {(j, j): j for j in range(nbr)}
    next_id = nbr
    for j in range(nbr):
        for i in col_rows[j]:
            tid[(i, j)] = next_id
            next_id += 1
    ntiles = next_id
    tile_brow = np.zeros(ntiles, np.int32)
    tile_bcol = np.zeros(ntiles, np.int32)
    for (i, j), t in tid.items():
        tile_brow[t] = i
        tile_bcol[t] = j

    segs = []
    for lv in range(int(level.max()) + 1 if nbr else 0):
        cols = np.flatnonzero(level == lv)
        sub_ids, sub_owner, sub_brow = [], [], []
        u_a, u_b, u_tgt = [], [], []
        base = {}
        for w, j in enumerate(cols):
            rows = col_rows[j]
            base[j] = len(sub_ids)
            for i in rows:
                sub_ids.append(tid[(i, j)])
                sub_owner.append(w)
                sub_brow.append(i)
        for j in cols:
            rows = col_rows[j]
            b0 = base[j]
            for x in range(len(rows)):
                for y in range(x, len(rows)):
                    a, b = rows[y], rows[x]          # a >= b
                    u_a.append(b0 + y)
                    u_b.append(b0 + x)
                    u_tgt.append(tid[(a, b)])
        segs.append(LevelSeg(
            cols=jnp.asarray(cols, jnp.int32),
            sub_ids=jnp.asarray(np.asarray(sub_ids, np.int32)),
            sub_owner=jnp.asarray(np.asarray(sub_owner, np.int32)),
            sub_brow=jnp.asarray(np.asarray(sub_brow, np.int32)),
            u_a=jnp.asarray(np.asarray(u_a, np.int32)),
            u_b=jnp.asarray(np.asarray(u_b, np.int32)),
            u_tgt=jnp.asarray(np.asarray(u_tgt, np.int32)),
        ))
    return LevelPlan(ntiles=ntiles, tile_brow=tile_brow,
                     tile_bcol=tile_bcol, segs=tuple(segs))


# ---------------------------------------------------------------------------
# Device: level-scheduled numeric factorization and substitution
# ---------------------------------------------------------------------------

def _batched_trsm(L, Bmat, lower=True, trans=False):
    """Solve L X = B (or Lᵀ X = B) for batched lower-triangular L."""
    return jax.scipy.linalg.solve_triangular(
        L, Bmat, lower=lower, trans=1 if trans else 0)


def level_factor_spd(T: jnp.ndarray, segs: Sequence[LevelSeg],
                     inv_factor: bool = True):
    """Level-scheduled right-looking tiled Cholesky.

    After the pass, diagonal tiles hold L_j (or L_j⁻¹ when ``inv_factor``)
    and subdiagonal tiles hold the L blocks. Returns (T, ok).
    """
    B = T.shape[-1]
    eye = jnp.eye(B, dtype=T.dtype)
    ok = jnp.asarray(True)
    for seg in segs:
        D = T[seg.cols]                              # (w, B, B)
        L = jnp.linalg.cholesky(D)
        ok_l = jnp.all(jnp.isfinite(L))
        L = jnp.where(ok_l, L, eye)
        Sub = T[seg.sub_ids]                         # (S, B, B)
        if inv_factor:
            Linv = _batched_trsm(L, jnp.broadcast_to(eye, L.shape))
            ok_l = ok_l & jnp.all(jnp.isfinite(Linv))
            Linv = jnp.where(ok_l, Linv, eye)
            # L_ij = T_ij L_j⁻ᵀ as a GEMM instead of a TRSM.
            Lsub = jnp.einsum("sbc,sdc->sbd", Sub, Linv[seg.sub_owner])
            diag_store = Linv
        else:
            Lj = L[seg.sub_owner]
            Lsub = _batched_trsm(Lj, Sub.transpose(0, 2, 1)
                                 ).transpose(0, 2, 1)
            diag_store = L
        Lsub = jnp.where(ok_l, Lsub, jnp.zeros_like(Lsub))
        T = T.at[seg.cols].set(jnp.where(ok_l, diag_store, eye))
        T = T.at[seg.sub_ids].set(Lsub)
        # All of the level's right-looking updates as one batched GEMM +
        # scatter-add (duplicate targets accumulate).
        La = Lsub[seg.u_a]
        Lb = Lsub[seg.u_b]
        T = T.at[seg.u_tgt].add(-jnp.einsum("ubc,udc->ubd", La, Lb))
        ok = ok & ok_l
    return T, ok


def level_factor_signed(T: jnp.ndarray, segs: Sequence[LevelSeg],
                        sgn_cols_fn, inv_factor: bool = True):
    """Level-scheduled signed blocked Cholesky K2 = 𝓛 Σ 𝓛ᵀ (see
    kkt/sparse_ldl.py for the per-tile math). ``sgn_cols_fn(cols)`` returns
    the (w, B) lane signs of the level's pivot tiles."""
    B = T.shape[-1]
    eye = jnp.eye(B, dtype=T.dtype)
    ok = jnp.asarray(True)
    for seg in segs:
        s = sgn_cols_fn(seg.cols)                    # (w, B)
        mx = (s < 0).astype(T.dtype)
        my = 1.0 - mx
        Dj = T[seg.cols]                             # (w, B, B)
        dmy = eye * my[:, None, :]
        dmx = eye * mx[:, None, :]
        Px = (-Dj) * (mx[:, :, None] * mx[:, None, :]) + dmy
        Lp = jnp.linalg.cholesky(Px)
        Bm = Dj * (my[:, :, None] * mx[:, None, :])
        W = _batched_trsm(Lp, Bm.transpose(0, 2, 1)).transpose(0, 2, 1)
        Sy = (Dj * (my[:, :, None] * my[:, None, :])
              + jnp.einsum("wbc,wdc->wbd", W, W) + dmx)
        Ls = jnp.linalg.cholesky(Sy)
        U = (Lp * (mx[:, :, None] * mx[:, None, :]) - W
             + Ls * (my[:, :, None] * my[:, None, :]))
        ok_l = jnp.all(jnp.isfinite(U))
        U = jnp.where(ok_l, U, eye)
        Sub = T[seg.sub_ids]
        if inv_factor:
            Uinv = _batched_trsm(U, jnp.broadcast_to(eye, U.shape))
            ok_l = ok_l & jnp.all(jnp.isfinite(Uinv))
            Uinv = jnp.where(ok_l, Uinv, eye)
            Y = jnp.einsum("sbc,sdc->sbd", Sub, Uinv[seg.sub_owner])
            diag_store = Uinv
        else:
            Uj = U[seg.sub_owner]
            Y = _batched_trsm(Uj, Sub.transpose(0, 2, 1)).transpose(0, 2, 1)
            diag_store = U
        so = s[seg.sub_owner]                        # (S, B) column signs
        Lsub = jnp.where(ok_l, Y * so[:, None, :], jnp.zeros_like(Y))
        T = T.at[seg.cols].set(jnp.where(ok_l, diag_store, eye))
        T = T.at[seg.sub_ids].set(Lsub)
        La = Lsub[seg.u_a] * so[seg.u_a][:, None, :]
        Lb = Lsub[seg.u_b]
        T = T.at[seg.u_tgt].add(-jnp.einsum("ubc,udc->ubd", La, Lb))
        ok = ok & ok_l
    return T, ok


def level_fwd(T: jnp.ndarray, segs: Sequence[LevelSeg], rhs_b: jnp.ndarray,
              inv_factor: bool = True) -> jnp.ndarray:
    """Blocked forward substitution 𝓛 u = rhs over the level schedule.
    ``rhs_b`` is (nbr, B); diagonal tiles hold L_j (or L_j⁻¹)."""
    y = rhs_b
    for seg in segs:
        yj = y[seg.cols]                             # (w, B)
        if inv_factor:
            yj = jnp.einsum("wbc,wc->wb", T[seg.cols], yj)
        else:
            yj = _batched_trsm(T[seg.cols], yj[..., None])[..., 0]
        y = y.at[seg.cols].set(yj)
        contrib = jnp.einsum("sbc,sc->sb", T[seg.sub_ids],
                             yj[seg.sub_owner])
        y = y.at[seg.sub_brow].add(-contrib)
    return y


def level_bwd(T: jnp.ndarray, segs: Sequence[LevelSeg], v: jnp.ndarray,
              inv_factor: bool = True) -> jnp.ndarray:
    """Blocked backward substitution 𝓛ᵀ x = v over the level schedule,
    processed root-level first."""
    x = jnp.zeros_like(v)
    for seg in reversed(segs):
        xg = x[seg.sub_brow]                         # (S, B)
        acc = jnp.einsum("sbc,sb->sc", T[seg.sub_ids], xg)
        w = seg.cols.shape[0]
        acc_col = jnp.zeros((w, v.shape[1]), v.dtype
                            ).at[seg.sub_owner].add(acc)
        r = v[seg.cols] - acc_col
        if inv_factor:
            xj = jnp.einsum("wcb,wc->wb", T[seg.cols], r)
        else:
            xj = _batched_trsm(T[seg.cols], r[..., None],
                               trans=True)[..., 0]
        x = x.at[seg.cols].set(xj)
    return x

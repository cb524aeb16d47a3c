"""Sparse-first standard-form LP data: no dense (m, n) matrix, ever.

This is the arbitrary-scale path — the role CHOLMOD-on-CSC plays in the
reference (reference: src/KKT/Cholmod/sqd.jl:42-53 factorizes a
SparseMatrixCSC of any size; src/problemData.jl:43-44 stores A as sparse
row+col lists; src/LinearAlgebra/LinearAlgebra.jl:14-32 builds CSC from
COO). The dense :class:`~tulip_tpu.ipm.data.LPData` caps problem size at
O(m·n) host+device bytes; for large sparse LPs this module assembles the
standard form **straight from COO** and stores A in the
support-compressed tile layout the level-scheduled KKT backend already
uses for its numeric phase (kkt/sparse.py SparseK1LevelState):

- host symbolic (O(nnz + tile work)): RCM on the K = A Aᵀ pattern, nested
  dissection over the tile graph, tile-granular fill, per-block-row
  column support — all from the scipy CSR pattern
  (:func:`tulip_tpu.kkt.sparse.k1_level_plan_pattern`);
- device storage: ``Apc`` (nbr, B, smax) — each 128-row block of the
  permuted A compressed to its column support. For an LP with ~c nnz/row
  this is O(m·smax) bytes instead of O(m·n).

Residual SpMVs (``matvec``/``rmatvec``) run as batched einsums over the
compressed blocks — no scalar gather loops — registered via
:func:`tulip_tpu.ipm.data.register_operator` so the HSD/MPC solvers use
them transparently. The level-scheduled K1 backend builds its tile
operands from the same arrays at ``setup_data`` without any dense
round-trip.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..problem import ProblemData
from .data import register_operator

INF = float("inf")


class SparseLPData(NamedTuple):
    """Standard-form LP with support-compressed tile storage of A.

    Array fields are a jit/vmap-safe pytree. ``segs`` is the static
    elimination-level schedule (tuple of LevelSeg of int32 device arrays)
    shared with the KKT backend.
    """

    Apc: jnp.ndarray        # (nbr, B, smax) permuted row blocks, compressed
    sup_idx: jnp.ndarray    # (nbr, smax) int32 column support (pad = n)
    perm: jnp.ndarray       # (m,) int32: position k holds original row perm[k]
    Atc: jnp.ndarray        # (nbc, Bc, rsmax) column blocks of Aᵀ, row-
                            # support compressed (original row order)
    rsup_idx: jnp.ndarray   # (nbc, rsmax) int32 row support (pad = m)
    U: jnp.ndarray          # (m, k) dense columns split out of the tile
                            # structure (k = 0 when none): A = As + U eᵀ
    dense_idx: jnp.ndarray  # (k,) int32 their column indices
    dense_onehot: jnp.ndarray  # (n, k) one-hot columns — dense-column
                            # contributions re-enter Aᵀy as a GEMM
                            # instead of a scatter
    tile_brow: jnp.ndarray  # (ntiles,) int32 block row of each K tile
    tile_bcol: jnp.ndarray  # (ntiles,) int32 block col of each K tile
    segs: tuple             # Tuple[LevelSeg, ...]
    b: jnp.ndarray          # (m,)
    c: jnp.ndarray          # (n,)
    c0: jnp.ndarray         # scalar
    l: jnp.ndarray          # (n,) finite values, 0 where masked
    u: jnp.ndarray          # (n,)
    lflag: jnp.ndarray      # (n,) {0., 1.}
    uflag: jnp.ndarray      # (n,) {0., 1.}

    @property
    def nrow(self) -> int:
        return self.perm.shape[0]

    @property
    def ncol(self) -> int:
        return self.c.shape[0]


def _matvec(dat: SparseLPData, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x over the compressed blocks (original row order); the split
    dense columns contribute through the skinny (m, k) GEMV."""
    m = dat.perm.shape[0]
    xs = jnp.concatenate([x, jnp.zeros(1, x.dtype)])[dat.sup_idx]
    yb = jnp.einsum("bis,bs->bi", dat.Apc, xs)
    out = jnp.zeros(m, yb.dtype).at[dat.perm].set(yb.reshape(-1)[:m])
    if dat.U.shape[1]:
        out = out + dat.U @ x[dat.dense_idx]
    return out


def _rmatvec(dat: SparseLPData, y: jnp.ndarray) -> jnp.ndarray:
    """Aᵀ @ y via the row-support-compressed COLUMN blocks — gather-only.

    A scatter-add formulation over ``sup_idx`` (the transpose of
    ``_matvec``) is mathematically equivalent. The dual compressed
    structure ``Atc`` costs one extra copy of the nonzeros and keeps the
    whole operator path gather+einsum; whether the scatter form is as
    fast on the GPU is not measured yet."""
    n = dat.c.shape[0]
    ys = jnp.concatenate([y, jnp.zeros(1, y.dtype)])[dat.rsup_idx]
    out = jnp.einsum("bis,bs->bi", dat.Atc, ys).reshape(-1)[:n]
    if dat.U.shape[1]:
        out = out + dat.dense_onehot @ (dat.U.T @ y)
    return out


register_operator(SparseLPData, _matvec, _rmatvec)


def standard_form_coo(pb: ProblemData) -> Tuple:
    """General form → standard form in COO, never materializing dense A.

    Same 5-way row case analysis as the dense
    :func:`~tulip_tpu.ipm.data.standard_form_arrays`
    (reference: src/IPM/ipmdata.jl:77-124); slack entries are appended to
    the COO triplets. Returns (I, J, V, ntot, b, c, c0, l, u, objsense).
    """
    m, n = pb.ncon, pb.nvar
    b = np.zeros(m)
    sind, sval, lslack, uslack = [], [], [], []
    lcon = np.asarray(pb.lcon, dtype=np.float64)
    ucon = np.asarray(pb.ucon, dtype=np.float64)

    for i in range(m):
        lb, ub = lcon[i], ucon[i]
        if lb == ub:
            b[i] = lb
        elif lb == -INF and ub == INF:
            sind.append(i); sval.append(1.0)
            lslack.append(-INF); uslack.append(INF)
            b[i] = 0.0
        elif lb == -INF and np.isfinite(ub):
            sind.append(i); sval.append(1.0)
            lslack.append(0.0); uslack.append(INF)
            b[i] = ub
        elif np.isfinite(lb) and ub == INF:
            sind.append(i); sval.append(-1.0)
            lslack.append(0.0); uslack.append(INF)
            b[i] = lb
        elif np.isfinite(lb) and np.isfinite(ub):
            sind.append(i); sval.append(1.0)
            lslack.append(0.0); uslack.append(ub - lb)
            b[i] = ub
        else:
            raise ValueError(f"Invalid bounds for row {i}: [{lb}, {ub}]")

    nslack = len(sind)
    ntot = n + nslack
    c = np.concatenate([np.asarray(pb.obj, dtype=np.float64),
                        np.zeros(nslack)])
    c0 = pb.obj0
    if not pb.objsense:
        c = -c
        c0 = -c0

    I0, J0, V0 = pb.to_coo()
    I = np.concatenate([I0, np.asarray(sind, np.int64)])
    J = np.concatenate([J0, n + np.arange(nslack, dtype=np.int64)])
    V = np.concatenate([V0, np.asarray(sval, np.float64)])

    l = np.concatenate([np.asarray(pb.lvar, dtype=np.float64),
                        np.asarray(lslack, dtype=np.float64)])
    u = np.concatenate([np.asarray(pb.uvar, dtype=np.float64),
                        np.asarray(uslack, dtype=np.float64)])
    return I, J, V, ntot, b, c, c0, l, u, pb.objsense


def sparse_lp_data_from_problem(
        pb: ProblemData, dtype=jnp.float64, block: int = 128,
        gate: float = 0.5, split_dense_cols: bool = True,
        ) -> Optional[Tuple["SparseLPData", int, bool]]:
    """ProblemData → (SparseLPData, n_structural, objsense), or None when
    the pattern gives the tile layout no advantage (caller falls back to
    the dense LPData path).

    ``split_dense_cols``: columns with ≥ dense_threshold(m) nonzeros are
    split out as the explicit skinny ``U`` (A = As + U eᵀ) so the tile
    structure is planned on the sparse part only — the same splitting
    the SMW backend performs (kkt/splitting.py), done here once at the
    data level so dense-column LPs keep the no-dense-(m, n) guarantee.

    Peak host memory is O(nnz + m·smax); the dense (m, n) array is never
    formed anywhere on this path.
    """
    import scipy.sparse as sp

    from ..kkt.sparse import k1_level_plan_pattern
    from ..kkt.sparse_ldl import dense_threshold

    I, J, V, ntot, b, c, c0, l, u, objsense = standard_form_coo(pb)
    m = pb.ncon
    A = sp.csr_matrix((V, (I, J)), shape=(m, ntot))
    A.sum_duplicates()

    # Dense-column split (on the standard-form matrix; slacks are never
    # dense). The tile plan and both compressed structures are built from
    # the SPARSE part As; U carries the dense columns explicitly.
    dense_idx = np.zeros(0, np.int64)
    if split_dense_cols:
        colnnz = np.diff(A.tocsc().indptr)
        dense_idx = np.flatnonzero(colnnz >= dense_threshold(m))
        if dense_idx.size > max(64, 0.02 * ntot):
            return None          # too many to be structure + exceptions
    if dense_idx.size:
        U_np = np.asarray(A[:, dense_idx].todense())
        A = A.tolil()
        A[:, dense_idx] = 0.0
        A = A.tocsr()
        A.eliminate_zeros()

    pattern = A.copy()
    pattern.data = np.ones_like(pattern.data, dtype=np.int32)
    lv = k1_level_plan_pattern(pattern, (m, ntot), block, gate)
    if lv is None:
        return None

    perm = lv["perm"]
    sup_idx = lv["sup_idx"]          # (nbr, smax), pad = ntot
    plan = lv["plan"]
    B = block
    nbr = -(-m // B)
    smax = sup_idx.shape[1]

    # Support-compressed permuted row blocks, straight from CSR slices.
    Aperm = A[perm].tocsr()
    Apc = np.zeros((nbr, B, smax), dtype=np.float64)
    for j in range(nbr):
        rows = Aperm[j * B:min((j + 1) * B, m)]
        sup = sup_idx[j]
        width = int(np.count_nonzero(sup < ntot))
        blockm = rows[:, sup[:width]].toarray()
        Apc[j, :blockm.shape[0], :width] = blockm

    # Dual structure for Aᵀ y (gather-only rmatvec): column blocks of Aᵀ
    # compressed to their row supports, in ORIGINAL row order.
    At = A.T.tocsr()                    # (ntot, m): row j = column j of A
    nbc = -(-ntot // B)
    rsups = []
    for j in range(nbc):
        rows = At[j * B:min((j + 1) * B, ntot)]
        rsups.append(np.unique(rows.indices))
    rsmax = max(max((len(s) for s in rsups), default=1), 1)
    rsup_idx = np.full((nbc, rsmax), m, np.int32)
    Atc = np.zeros((nbc, B, rsmax), dtype=np.float64)
    for j, s in enumerate(rsups):
        rsup_idx[j, :len(s)] = s
        blockm = At[j * B:min((j + 1) * B, ntot)][:, s].toarray()
        Atc[j, :blockm.shape[0], :len(s)] = blockm

    k = dense_idx.size
    onehot = np.zeros((ntot, k), dtype=np.float64)
    if k:
        onehot[dense_idx, np.arange(k)] = 1.0

    lf = np.isfinite(l)
    uf = np.isfinite(u)
    dat = SparseLPData(
        Apc=jnp.asarray(Apc, dtype=dtype),
        sup_idx=jnp.asarray(sup_idx, jnp.int32),
        perm=jnp.asarray(perm, jnp.int32),
        Atc=jnp.asarray(Atc, dtype=dtype),
        rsup_idx=jnp.asarray(rsup_idx, jnp.int32),
        U=(jnp.asarray(U_np, dtype=dtype) if k
           else jnp.zeros((m, 0), dtype=dtype)),
        dense_idx=jnp.asarray(dense_idx, jnp.int32),
        dense_onehot=jnp.asarray(onehot, dtype=dtype),
        tile_brow=jnp.asarray(plan.tile_brow, jnp.int32),
        tile_bcol=jnp.asarray(plan.tile_bcol, jnp.int32),
        segs=plan.segs,
        b=jnp.asarray(b, dtype=dtype),
        c=jnp.asarray(c, dtype=dtype),
        c0=jnp.asarray(c0, dtype=dtype),
        l=jnp.asarray(np.where(lf, l, 0.0), dtype=dtype),
        u=jnp.asarray(np.where(uf, u, 0.0), dtype=dtype),
        lflag=jnp.asarray(lf, dtype=dtype),
        uflag=jnp.asarray(uf, dtype=dtype),
    )
    return dat, pb.nvar, objsense


def sparse_pattern_signals(pb: ProblemData) -> dict:
    """O(nnz) pattern + value signals for the sparse-first routing
    decision (the dense probe's job, without its O(m·n) host scan):
    density, dense-column count, and the dense-column norm-dominance
    ratio the measured smw-vs-K2 rule uses (model.py)."""
    from ..kkt.sparse_ldl import dense_threshold

    I, J, V = pb.to_coo()
    m, n = pb.ncon, pb.nvar
    nnz = len(V)
    colnnz = np.bincount(J, minlength=n) if nnz else np.zeros(n, np.int64)
    dense_cols = colnnz >= dense_threshold(m) if nnz else \
        np.zeros(n, bool)
    norm_ratio = 0.0
    if nnz and dense_cols.any():
        cnorm = np.sqrt(np.bincount(J, V * V, minlength=n))
        sparse_norms = cnorm[~dense_cols]
        med = float(np.median(sparse_norms[sparse_norms > 0])) \
            if (sparse_norms > 0).any() else 1.0
        norm_ratio = float(cnorm[dense_cols].max() / max(med, 1e-300))
    return dict(
        nnz=nnz,
        density=nnz / max(m * n, 1),
        max_colnnz=int(colnnz.max()) if n else 0,
        n_dense_cols=int(dense_cols.sum()),
        dense_norm_ratio=norm_ratio,
    )

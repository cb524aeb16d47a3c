"""Standard-form LP data as a JAX pytree.

The problem seen by the IPM is (reference: src/IPM/ipmdata.jl:1-13)::

    min  c'x + c0
    s.t. A x = b
         l <= x <= u        (entries of l, u may be infinite)

Infinite bounds are carried as float masks ``lflag``/``uflag`` — the same
multiply-by-mask pattern the reference uses "to ease GPU support"
(reference: src/IPM/ipmdata.jl:33-39) — which is exactly what jit/vmap-able
TPU code needs: masked arithmetic instead of data-dependent branches.

The conversion from a general ``ProblemData`` appends one slack column per
non-equality row, with the same 5-way row case analysis as the reference
(reference: src/IPM/ipmdata.jl:77-124).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..problem import ProblemData

INF = float("inf")


class LPData(NamedTuple):
    """Standard-form problem data; a pytree of device arrays.

    ``A`` is the dense constraint matrix (m, n). Dense is the deliberate
    choice for small/medium LPs and batched scenario solves — the
    normal-equations products are plain GEMMs; structured/blocked
    matrices get their own data types and KKT backends.

    ``l``/``u`` are finite-valued (masked entries hold 0), ``lflag``/``uflag``
    are {0,1} float masks of which bounds exist.
    """

    A: jnp.ndarray       # (m, n)
    b: jnp.ndarray       # (m,)
    c: jnp.ndarray       # (n,)
    c0: jnp.ndarray      # scalar
    l: jnp.ndarray       # (n,) finite values, 0 where masked
    u: jnp.ndarray       # (n,)
    lflag: jnp.ndarray   # (n,) {0., 1.}
    uflag: jnp.ndarray   # (n,) {0., 1.}

    @property
    def nrow(self) -> int:
        return self.A.shape[-2]

    @property
    def ncol(self) -> int:
        return self.A.shape[-1]


def matvec(dat, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x for any LP data structure. Structured data types (e.g.
    block-angular) register their own overload via ``register_matvec``."""
    fn = _MATVEC.get(type(dat))
    if fn is not None:
        return fn(dat, x)
    return dat.A @ x


def rmatvec(dat, y: jnp.ndarray) -> jnp.ndarray:
    """Aᵀ @ y for any LP data structure."""
    fn = _RMATVEC.get(type(dat))
    if fn is not None:
        return fn(dat, y)
    return dat.A.T @ y


_MATVEC: dict = {}
_RMATVEC: dict = {}


def register_operator(cls, mv, rmv) -> None:
    _MATVEC[cls] = mv
    _RMATVEC[cls] = rmv


def make_lp_data(A, b, c, c0, l, u, dtype=jnp.float64) -> LPData:
    """Build an LPData from possibly-infinite bounds (host helper)."""
    A = jnp.asarray(A, dtype=dtype)
    b = jnp.asarray(b, dtype=dtype)
    c = jnp.asarray(c, dtype=dtype)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    lflag = np.isfinite(l)
    uflag = np.isfinite(u)
    lv = np.where(lflag, l, 0.0)
    uv = np.where(uflag, u, 0.0)
    return LPData(
        A=A, b=b, c=c, c0=jnp.asarray(c0, dtype=dtype),
        l=jnp.asarray(lv, dtype=dtype), u=jnp.asarray(uv, dtype=dtype),
        lflag=jnp.asarray(lflag, dtype=dtype),
        uflag=jnp.asarray(uflag, dtype=dtype),
    )


def standard_form_arrays(pb: ProblemData) -> Tuple[np.ndarray, ...]:
    """Convert general-form ``pb`` to standard-form numpy arrays.

    Returns (A, b, c, c0, l, u, objsense). Row case analysis mirrors the
    reference (reference: src/IPM/ipmdata.jl:77-124):

    - equality row      a'x  = b          : no slack
    - free row          -inf <= a'x <= inf: slack +1, free
    - a'x <= ub                           : slack +1 in [0, inf), b = ub
    - a'x >= lb                           : slack -1 in [0, inf), b = lb
    - lb <= a'x <= ub (range)             : slack +1 in [0, ub-lb], b = ub
    """
    m, n = pb.ncon, pb.nvar
    b = np.zeros(m)
    sind, sval, lslack, uslack = [], [], [], []

    for i, (lb, ub) in enumerate(zip(pb.lcon, pb.ucon)):
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
    c = np.concatenate([np.asarray(pb.obj, dtype=np.float64),
                        np.zeros(nslack)])
    c0 = pb.obj0
    if not pb.objsense:
        # Flip objective for maximization (reference: ipmdata.jl:130-135).
        c = -c
        c0 = -c0

    A = np.zeros((m, n + nslack))
    I, J, V = pb.to_coo()
    if len(I):
        A[I, J] = V
    for k, (i, v) in enumerate(zip(sind, sval)):
        A[i, n + k] = v

    l = np.concatenate([np.asarray(pb.lvar, dtype=np.float64),
                        np.asarray(lslack, dtype=np.float64)])
    u = np.concatenate([np.asarray(pb.uvar, dtype=np.float64),
                        np.asarray(uslack, dtype=np.float64)])
    return A, b, c, c0, l, u, pb.objsense


def lp_data_from_problem(pb: ProblemData, dtype=jnp.float64,
                         ) -> Tuple[LPData, int, bool]:
    """ProblemData -> (LPData, n_structural_vars, objsense)."""
    A, b, c, c0, l, u, objsense = standard_form_arrays(pb)
    return make_lp_data(A, b, c, c0, l, u, dtype=dtype), pb.nvar, objsense

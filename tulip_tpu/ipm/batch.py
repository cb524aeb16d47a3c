"""Scenario-batched LP solves: vmap over the whole IPM.

The reference is strictly single-problem, single-thread (reference:
SURVEY §2.6; src/model.jl:73 only sets BLAS threads). On an accelerator the
win comes from batching: because the entire HSD solve is pure jitted code over
pytrees (:mod:`.hsd`), ``vmap`` gives a batched solver for free — every
iterate, residual, factorization and backsolve gains a leading batch
dimension, so the per-iteration work becomes batched GEMMs / batched
Cholesky.

Convergence is per-instance: ``lax.while_loop`` under ``vmap`` keeps
iterating until every lane's predicate is false, while each converged
lane's terminal status freezes its state through the ``lax.cond`` →
``select`` masking in ``hsd_iteration``.

Heterogeneous instances are padded to a common (m, n) envelope by
:func:`pad_lp`: padded rows are `0·x = 0` (with a unit diagonal slack
pinned to 0 … not needed — a zero row with b=0 is harmless to the IPM
because regularization keeps AΘAᵀ+Rd nonsingular), padded columns are
fixed at 0 by bounds l = u = 0.
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp

from .data import LPData
from .hsd import (HSDOptions, HSDState, full_matmul_precision,
                  hsd_iteration, init_state)

_UNKNOWN = 1  # TerminationStatus.UNKNOWN


def pad_lp(dat: LPData, m_pad: int, n_pad: int) -> LPData:
    """Embed an (m, n) problem into an (m_pad, n_pad) envelope.

    Padded columns get c = 0 and bounds l = u = 0 (both flags on), pinning
    them to zero; padded rows are all-zero with b = 0, which the dual
    regularization keeps nonsingular and whose y components converge to 0.
    """
    m, n = dat.nrow, dat.ncol
    dm, dn = m_pad - m, n_pad - n
    if dm < 0 or dn < 0:
        raise ValueError("pad target smaller than problem")
    one = jnp.ones(dn, dtype=dat.c.dtype)
    return LPData(
        A=jnp.pad(dat.A, ((0, dm), (0, dn))),
        b=jnp.pad(dat.b, (0, dm)),
        c=jnp.pad(dat.c, (0, dn)),
        c0=dat.c0,
        l=jnp.pad(dat.l, (0, dn)),
        u=jnp.pad(dat.u, (0, dn)),
        lflag=jnp.concatenate([dat.lflag, one]),
        uflag=jnp.concatenate([dat.uflag, one]),
    )


def stack_lps(dats: List[LPData]) -> LPData:
    """Stack equal- or mixed-shape LPs into one batched LPData, padding to
    the common envelope."""
    m_pad = max(d.nrow for d in dats)
    n_pad = max(d.ncol for d in dats)
    padded = [pad_lp(d, m_pad, n_pad) for d in dats]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *padded)


def bucket_dim(v: int, lo: int = 16) -> int:
    """Pad target for heterogeneous batching: next power of two ≥ v
    (floor ``lo``). Bounds padding waste to <2× per dimension while
    capping the number of distinct compiled shapes at log²."""
    p = lo
    while p < v:
        p *= 2
    return p


def stack_lps_host(problems, dtype=None, m_pad=None, n_pad=None) -> LPData:
    """Host-side batch builder: pad + stack raw ``(A, b, c, c0, l, u)``
    tuples with numpy and transfer ONE array per LPData leaf.

    Building per-instance device LPData and stacking on device
    (:func:`stack_lps`) dispatches thousands of tiny transfers/ops — fine
    for small batches, slow for thousands of instances. This path keeps everything in numpy until the single final transfer.

    Bounds may be infinite; they become the l/u + lflag/uflag masked form.
    Padded columns are pinned to zero (l = u = 0, both flags on) and padded
    rows are zero rows with b = 0, exactly like :func:`pad_lp`.
    """
    import numpy as np

    if dtype is None:
        dtype = jnp.float64
    B = len(problems)
    if m_pad is None:
        m_pad = max(np.shape(p[0])[0] for p in problems)
    if n_pad is None:
        n_pad = max(np.shape(p[0])[1] for p in problems)
    A_ = np.zeros((B, m_pad, n_pad))
    b_ = np.zeros((B, m_pad))
    c_ = np.zeros((B, n_pad))
    c0_ = np.zeros(B)
    l_ = np.zeros((B, n_pad))
    u_ = np.zeros((B, n_pad))
    lf_ = np.ones((B, n_pad))
    uf_ = np.ones((B, n_pad))
    for k, (A, b, c, c0, l, u) in enumerate(problems):
        A = np.asarray(A, dtype=np.float64)
        mm, nn = A.shape
        A_[k, :mm, :nn] = A
        b_[k, :mm] = b
        c_[k, :nn] = c
        c0_[k] = c0
        l = np.asarray(l, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        lf = np.isfinite(l)
        uf = np.isfinite(u)
        l_[k, :nn] = np.where(lf, l, 0.0)
        u_[k, :nn] = np.where(uf, u, 0.0)
        lf_[k, :nn] = lf
        uf_[k, :nn] = uf
    return LPData(
        A=jnp.asarray(A_, dtype), b=jnp.asarray(b_, dtype),
        c=jnp.asarray(c_, dtype), c0=jnp.asarray(c0_, dtype),
        l=jnp.asarray(l_, dtype), u=jnp.asarray(u_, dtype),
        lflag=jnp.asarray(lf_, dtype), uflag=jnp.asarray(uf_, dtype),
    )


def _solve_one(backend, opts: HSDOptions, dat: LPData) -> HSDState:
    state = init_state(dat, backend, mehrotra=opts.MehrotraStart)

    def cond(s):
        return s.status == _UNKNOWN

    def body(s):
        return hsd_iteration(backend, opts, dat, s)

    return jax.lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def batched_hsd_solve(backend, opts: HSDOptions, dats: LPData) -> HSDState:
    """Solve a batch of LPs (leading axis on every LPData leaf)."""
    return jax.vmap(lambda d: _solve_one(backend, opts, d))(dats)


@partial(jax.jit, static_argnames=("backend", "opts", "lam"))
@full_matmul_precision
def batched_hsd_resolve(backend, opts: HSDOptions, dats: LPData,
                        prev: HSDState, lam: float = 0.99) -> HSDState:
    """Warm-started batched re-solve: each lane starts from the blended
    homogeneous restart of its previous final state (:mod:`.warmstart`).
    For perturbed-scenario sweeps this roughly halves iteration counts
    versus cold starts."""
    from .warmstart import warm_state

    def solve_one(dat, pv):
        state = warm_state(dat, backend, pv, lam=lam)

        def cond(s):
            return s.status == _UNKNOWN

        def body(s):
            return hsd_iteration(backend, opts, dat, s)

        return jax.lax.while_loop(cond, body, state)

    return jax.vmap(solve_one)(dats, prev)


def _solve_one_mpc(backend, opts, dat: LPData) -> HSDState:
    from .mpc import init_state_mpc, mpc_iteration

    state = init_state_mpc(dat, backend)

    def cond(s):
        return s.status == _UNKNOWN

    def body(s):
        return mpc_iteration(backend, opts, dat, s)

    return jax.lax.while_loop(cond, body, state)


@partial(jax.jit, static_argnames=("backend", "opts"))
@full_matmul_precision
def batched_mpc_solve(backend, opts, dats: LPData) -> HSDState:
    """Batched Mehrotra predictor-corrector solves (MPCOptions)."""
    return jax.vmap(lambda d: _solve_one_mpc(backend, opts, d))(dats)


def shard_batch(dats: LPData, mesh, axis: str = "batch") -> LPData:
    """Place a stacked batch with its leading axis sharded over ``mesh``;
    under jit the whole batched solve then partitions across devices with
    zero collectives (embarrassingly parallel over devices)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, dats)

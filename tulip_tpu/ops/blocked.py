"""Recursive blocked Cholesky + triangular-inverse for large dense SPD
matrices.

XLA's native ``cholesky`` and ``triangular_solve`` use panel algorithms
that serialize on narrow TRSMs. This module re-expresses both as a single
recursive bisection in which ALL work above the leaf size is plain GEMMs:

    K = [[K11, K21ᵀ], [K21, K22]]
    L11, X11 = factor(K11)              # recurse
    L21  = K21 X11ᵀ                     # GEMM
    S    = K22 − L21 L21ᵀ               # GEMM (Schur complement)
    L22, X22 = factor(S)                # recurse
    X21  = −X22 (L21 X11)               # 2 GEMMs
    L = [[L11, 0], [L21, L22]],  X = L⁻¹ = [[X11, 0], [X21, X22]]

The leaf uses XLA's cholesky + triangular inverse at a size where they
are cheap. Producing L and L⁻¹ together costs the same GEMMs the
inverse-factor path already pays (one TRSM with m right-hand sides),
re-ordered as large matmuls. Whether this beats XLA's own factorization
(cuSOLVER on the GPU) at IPM sizes is not measured yet; ``blocked_min``
in the dense backends sets where it engages.

Numerics: the Cholesky recursion is the standard blocked right-looking
algorithm (backward stable); the inverse assembly amplifies by κ(L)
exactly like the one-shot TRSM it replaces — the dense backend pairs it
with iterative refinement, unchanged.

No reference analogue: Tulip's dense backend calls LAPACK POTRF
(reference: src/KKT/Dense/lapack.jl:83-97).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _leaf(K):
    L = jnp.linalg.cholesky(K)
    X = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(K.shape[0], dtype=K.dtype), lower=True)
    return L, X


def cholesky_invfactor_blocked(K: jnp.ndarray, leaf: int = 2048):
    """Return ``(L, X)`` with ``K = L Lᵀ`` and ``X = L⁻¹``.

    Shapes are static under jit (the recursion unrolls at trace time).
    Non-SPD inputs yield NaNs in the leaf factors, which propagate to
    the output — callers detect failure with ``isfinite`` exactly as
    with ``jnp.linalg.cholesky``.
    """
    m = K.shape[0]
    if m <= leaf:
        return _leaf(K)
    # Split near m/2, rounded UP to a multiple of 256 (or of the leaf
    # size when smaller): p is always in [align, m).
    align = min(256, leaf)
    p = -(-(m // 2) // align) * align
    K11 = K[:p, :p]
    K21 = K[p:, :p]
    K22 = K[p:, p:]
    L11, X11 = cholesky_invfactor_blocked(K11, leaf)
    L21 = K21 @ X11.T
    S = K22 - L21 @ L21.T
    L22, X22 = cholesky_invfactor_blocked(S, leaf)
    X21 = -(X22 @ (L21 @ X11))
    z = jnp.zeros((p, m - p), K.dtype)
    L = jnp.block([[L11, z], [L21, L22]])
    X = jnp.block([[X11, z], [X21, X22]])
    return L, X

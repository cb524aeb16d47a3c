"""Double-double (compensated f64-pair) arithmetic primitives.

The reference exercises its whole stack in ``BigFloat`` via Julia's generic
arithmetic (reference: test/runtests.jl:9, src/KKT/LDLFactorizations/
ldlfact.jl — the any-precision LDLᵀ path). TPUs have no arbitrary-precision
unit, so the TPU-native equivalent of "more bits than f64" is **double-word
arithmetic**: a value is an unevaluated sum ``hi + lo`` of two f64s
(~106-bit significand, ε ≈ 2⁻¹⁰⁵ ≈ 2.5e-32). All primitives below are
built from the classical error-free transforms (Knuth two-sum, Dekker
split/two-prod — no FMA required, so they are exact on any IEEE-754 f64
path including XLA:CPU and the TPU's emulated f64) and the double-word
algorithms of Joldes, Muller & Popescu (2017).

Everything is expressed as elementwise jnp ops + O(log n) pairwise
reduction levels, so the routines jit/vmap and stay vectorized —
an extended-precision matvec is a broadcasted two-prod followed by a
log-depth compensated tree sum, not a scalar loop.

A dd value is a plain ``(hi, lo)`` tuple of equal-shape f64 arrays; the
module is functional (no classes) so results thread through pytrees.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

DD = Tuple[jnp.ndarray, jnp.ndarray]

# Dekker splitter for binary64: 2^27 + 1.
_SPLIT = 134217729.0


# ---------------------------------------------------------------------------
# Error-free transforms
# ---------------------------------------------------------------------------

def two_sum(a, b) -> DD:
    """s + e == a + b exactly, s = fl(a+b) (Knuth; no branch, no FMA)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> DD:
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a) -> DD:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> DD:
    """p + e == a * b exactly (Dekker/Veltkamp product, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# Double-word arithmetic (Joldes-Muller-Popescu accurate variants)
# ---------------------------------------------------------------------------

def from_f(a) -> DD:
    a = jnp.asarray(a, dtype=jnp.float64)
    return a, jnp.zeros_like(a)


def to_f(x: DD) -> jnp.ndarray:
    return x[0] + x[1]


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def add(x: DD, y: DD) -> DD:
    """dd + dd (AccurateDWPlusDW, ~3u² relative error)."""
    sh, sl = two_sum(x[0], y[0])
    th, tl = two_sum(x[1], y[1])
    c = sl + th
    vh, vl = fast_two_sum(sh, c)
    w = tl + vl
    return fast_two_sum(vh, w)


def sub(x: DD, y: DD) -> DD:
    return add(x, neg(y))


def add_f(x: DD, b) -> DD:
    """dd + f64 (DWPlusFP, ~2u²)."""
    sh, sl = two_sum(x[0], b)
    v = x[1] + sl
    return fast_two_sum(sh, v)


def mul_ff(a, b) -> DD:
    """f64 * f64 -> exact dd."""
    return two_prod(a, b)


def mul_f(x: DD, b) -> DD:
    """dd * f64 (DWTimesFP3, ~2u²)."""
    ch, cl1 = two_prod(x[0], b)
    cl3 = x[1] * b + cl1
    return fast_two_sum(ch, cl3)


def mul(x: DD, y: DD) -> DD:
    """dd * dd (DWTimesDW, ~5u²)."""
    ch, cl1 = two_prod(x[0], y[0])
    tl = x[0] * y[1] + x[1] * y[0]
    cl2 = tl + cl1
    return fast_two_sum(ch, cl2)


def div(x: DD, y: DD) -> DD:
    """dd / dd (DWDivDW2, ~15u²): one f64 quotient + a dd residual
    correction."""
    th = x[0] / y[0]
    r = sub(x, mul_f(y, th))
    tl = r[0] / y[0]
    return fast_two_sum(th, tl)


def recip(y: DD) -> DD:
    """1 / dd."""
    th = 1.0 / y[0]
    r = sub(from_f(jnp.ones_like(y[0])), mul_f(y, th))
    tl = r[0] / y[0]
    return fast_two_sum(th, tl)


def sqrt_(x: DD) -> DD:
    """sqrt of a nonnegative dd (one Newton/Heron correction of the f64
    root: s + (x − s²)/(2s), accurate to ~3u²). x <= 0 propagates the
    f64 sqrt's NaN/0 — callers treat NaN as factorization failure."""
    s = jnp.sqrt(x[0])
    r = sub(x, mul_ff(s, s))
    t = r[0] / jnp.where(s > 0, 2.0 * s, 1.0)
    return fast_two_sum(s, jnp.where(s > 0, t, jnp.zeros_like(t)))


# ---------------------------------------------------------------------------
# Reductions / linear algebra
# ---------------------------------------------------------------------------

def _pad_even(h, l, axis):
    n = h.shape[axis]
    if n % 2:
        pad = [(0, 0)] * h.ndim
        pad[axis] = (0, 1)
        h = jnp.pad(h, pad)
        l = jnp.pad(l, pad)
    return h, l


def sum_(x: DD, axis: int = -1) -> DD:
    """Compensated sum along ``axis``: pairwise dd-add tree, log₂(n) levels
    of full-width vector ops (parallel on VPU; no sequential scan)."""
    h, l = x
    axis = axis % h.ndim
    while h.shape[axis] > 1:
        h, l = _pad_even(h, l, axis)
        n = h.shape[axis]
        lo_idx = jnp.arange(0, n, 2)
        hi_idx = jnp.arange(1, n, 2)
        a = (jnp.take(h, lo_idx, axis=axis), jnp.take(l, lo_idx, axis=axis))
        b = (jnp.take(h, hi_idx, axis=axis), jnp.take(l, hi_idx, axis=axis))
        h, l = add(a, b)
    h = jnp.squeeze(h, axis=axis)
    l = jnp.squeeze(l, axis=axis)
    return h, l


def dot(a, b) -> DD:
    """Compensated inner product of two f64 vectors (Dot2-grade accuracy:
    exact products + dd tree sum)."""
    p = two_prod(a, b)
    return sum_(p, axis=-1)


def matvec(A, x) -> DD:
    """A @ x with exact elementwise products and dd row sums.

    A: (m, n) f64, x: (n,) f64 → dd (m,). One broadcasted two-prod plus
    log₂(n) vector adds — the jit-friendly shape of an extended-precision
    SpMV-equivalent."""
    p = two_prod(A, x[None, :])
    return sum_(p, axis=1)


def ewmul_vec(a, x) -> DD:
    """Elementwise a∘x of two f64 vectors as exact dd."""
    return two_prod(a, x)

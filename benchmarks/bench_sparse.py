"""Measure dense vs banded vs tiled-sparse K1 backends on a large
staircase problem, on the default device.

Usage: python benchmarks/bench_sparse.py [m]
"""

import sys
import time

import jax

jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np


def staircase(m, dtype, cyclic=False):
    """Staircase constraint pattern; ``cyclic`` adds a wrap-around coupling
    (periodic/cyclic planning horizon) whose corner block defeats a pure
    band ordering but stays cheap for tile-granular fill."""
    rng = np.random.default_rng(0)
    mr, nc = 64, 96
    stages = m // mr
    n = stages * nc + (0 if cyclic else nc)
    A = np.zeros((m, n), dtype)
    for s in range(stages):
        A[s*mr:(s+1)*mr, s*nc:(s+1)*nc] = rng.standard_normal(
            (mr, nc)).astype(dtype)
        t = ((s + 1) % stages) if cyclic else (s + 1)
        A[s*mr:(s+1)*mr, t*nc:(t+1)*nc] = rng.standard_normal(
            (mr, nc)).astype(dtype)
    return A


def time_backend(be, A, iters=10):
    m, n = A.shape
    rng = np.random.default_rng(1)
    theta_inv = jnp.asarray(10.0 ** rng.uniform(-2, 2, n), A.dtype)
    regP = jnp.full(n, 1e-6, A.dtype)
    regD = jnp.full(m, 1e-6, A.dtype)
    xi_p = jnp.asarray(rng.standard_normal(m), A.dtype)
    xi_d = jnp.asarray(rng.standard_normal(n), A.dtype)
    st = be.setup(jnp.asarray(A))

    @jax.jit
    def step(st, ti):
        st, ok = be.update(st, ti, regP, regD)
        dx, dy = be.solve(st, xi_p, xi_d)
        return st, ok, dx, dy

    st2, ok, dx, dy = jax.block_until_ready(step(st, theta_inv))
    t0 = time.perf_counter()
    for _ in range(iters):
        st2, ok, dx, dy = step(st, theta_inv)
    jax.block_until_ready((st2, ok, dx, dy))
    dt = (time.perf_counter() - t0) / iters
    rd = xi_d - (-(theta_inv + regP) * dx + jnp.asarray(A).T @ dy)
    rp = xi_p - (jnp.asarray(A) @ dx + regD * dy)
    res = max(float(jnp.max(jnp.abs(rd))), float(jnp.max(jnp.abs(rp))))
    return dt, res, bool(ok), type(st).__name__


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    from tulip_tpu.kkt import (BandedK1Backend, DenseK1Backend,
                               SparseK1Backend)
    from tulip_tpu.utils import enable_compile_cache

    enable_compile_cache()
    cyclic = "--cyclic" in sys.argv
    for dtype in (np.float32,):
        A = staircase(m, dtype, cyclic=cyclic)
        print(f"m={A.shape[0]} n={A.shape[1]} cyclic={cyclic} "
              f"dtype={np.dtype(dtype).name} "
              f"platform={jax.devices()[0].platform}")
        for be in (DenseK1Backend(inv_factor=True),
                   BandedK1Backend(min_block=128),
                   SparseK1Backend(block=128),
                   SparseK1Backend(block=256)):
            label = f"{be.name}" + (f"-B{be.block}" if be.name == "sparse"
                                    else "")
            dt, res, ok, stname = time_backend(be, A)
            print(f"  {label:12s} {dt*1e3:9.2f} ms/iter  resid {res:.2e}"
                  f"  ok={ok} state={stname}")


if __name__ == "__main__":
    main()

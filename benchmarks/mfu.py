"""KKT factorize+solve GFLOP/s per card and share of the card's peak.

For each KKT backend and problem size, time one update (numeric
factorization) + one solve on the default device, count the algorithmic
FLOPs the backend actually executes (from its own static plan), and report
GFLOP/s and % of the card's published peak for the dtype.

Usage: python benchmarks/mfu.py [--sizes 1024,2048,4096] [--dtype float32]
Writes a table to stderr and JSON rows to stdout.
"""

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.dirname(_HERE))   # repo root for tulip_tpu
from bench_sparse import staircase  # noqa: E402
from card import device_peaks  # noqa: E402
from tulip_tpu.utils import enable_compile_cache  # noqa: E402

def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# FLOP models: algorithmic flops each backend executes for one
# update (assembly + factorization) + one unrefined solve, derived from
# the backend's own static plan (state array shapes).
# ---------------------------------------------------------------------------

def flops_dense(state, m, n):
    assemble = 2 * m * m * n
    chol = m ** 3 / 3
    invfac = m ** 3 / 3            # triangular inverse (inv_factor=True)
    solve = 4 * m * m              # two GEMVs with L^-1 / L^-T
    return assemble + chol + invfac + solve


def flops_banded(state, m, n):
    if hasattr(state, "segs"):       # delegated to the level engine
        return flops_sparse(state, m, n)
    nb, bw, _ = state.L.shape
    assemble = 4 * nb * bw * bw * n          # D_i and E_i blocks
    factor = nb * (bw ** 3 / 3 + bw ** 3 + 2 * bw ** 3)
    solve = nb * 8 * bw * bw
    return assemble + factor + solve


def _level_counts(state):
    """(nbr, B, ntiles, nsub, nupd) from a level-scheduled state."""
    ntiles = state.T.shape[0]
    B = state.T.shape[1]
    nbr = ntiles - sum(int(s.sub_ids.shape[0]) for s in state.segs)
    nsub = ntiles - nbr
    nupd = sum(int(s.u_a.shape[0]) for s in state.segs)
    return nbr, B, ntiles, nsub, nupd


def flops_sparse(state, m, n):
    if hasattr(state, "segs"):       # level schedule (kkt/levels.py)
        nbr, B, ntiles, nsub, nupd = _level_counts(state)
        smax = state.sup_idx.shape[1]
        # Support-compressed assembly: each tile contracts over the owner
        # column's support only.
        assemble = ntiles * 2 * B * B * smax
        # chol + triangular inverse per pivot, GEMM per sub tile and per
        # right-looking update.
        factor = nbr * (B ** 3 / 3 + B ** 3) + (nsub + 2 * nupd) * B ** 3
        solve = (nbr + nsub) * 4 * B * B
        return assemble + factor + solve
    nbr, B, _ = state.Ap.shape
    cmax = state.col_ids.shape[1]
    umax = state.u_a.shape[1]
    assemble = nbr * (cmax + 1) * 2 * B * B * n
    factor = nbr * (B ** 3 / 3 + cmax * B ** 3 + umax * 2 * B ** 3)
    solve = 2 * nbr * (1 + cmax) * 2 * B * B
    return assemble + factor + solve


def flops_sparse_ldl(state, m, n):
    # K2 backend: nodes over N = n + m, signed blocked Cholesky.
    # Nominal useful-flops convention for the default (inv_factor=True,
    # constant-tile rescale assembly) path: the rescale is 3 elementwise
    # passes over the tile store; pivot work is 2 masked Choleskys + the
    # W TRSM + W Wᵀ GEMM + the U⁻¹ TRSM; L tiles and solves are GEMMs.
    if hasattr(state, "segs"):       # level schedule
        nbr, B, ntiles, nsub, nupd = _level_counts(state)
        assemble = ntiles * 3 * B * B
        factor = (nbr * (2 * B ** 3 / 3 + B ** 3 + 2 * B ** 3 + B ** 3)
                  + (2 * nsub + 2 * nupd) * B ** 3)
        solve = (nbr + nsub) * 4 * B * B
        return assemble + factor + solve
    nbr = state.nodes.shape[0] - 1
    B = state.nodes.shape[1]
    cmax = state.col_ids.shape[1]
    umax = state.u_a.shape[1]
    assemble = (nbr + 1 + nbr * cmax) * 3 * B * B    # rescale passes
    factor = nbr * (2 * B ** 3 / 3 + B ** 3 + 2 * B ** 3 + B ** 3
                    + cmax * 2 * B ** 3 + umax * 2 * B ** 3)
    solve = nbr * (4 * B * B + cmax * 4 * B * B)
    return assemble + factor + solve


def flops_smw(state, m, n):
    inner = flops_sparse(state.inner, m, n)
    k = state.U.shape[1]
    if hasattr(state.inner, "segs"):
        nbr, B, ntiles, nsub, _ = _level_counts(state.inner)
        extra_solves = k * (nbr + nsub) * 4 * B * B       # V = B^-1 U
    else:
        nbr, B, _ = state.inner.Ap.shape
        cmax = state.inner.col_ids.shape[1]
        extra_solves = k * 2 * nbr * (1 + cmax) * 2 * B * B
    small = 2 * m * k * k + k ** 3 / 3
    return inner + extra_solves + small + 4 * m * k


def measure(be, A, flops_fn, iters=10):
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
        st2, ok = be.update(st, ti, regP, regD)
        dx, dy = be.solve_unrefined(st2, xi_p, xi_d)
        return ok, dx, dy

    out = jax.block_until_ready(step(st, theta_inv))   # compile
    # Distinct pre-built inputs per iteration, materialized BEFORE the
    # timed loop, so the loop holds no eager dispatches.
    thetas = [theta_inv * (1.0 + 1e-6 * (i + 1)) for i in range(iters)]
    jax.block_until_ready(thetas)
    t0 = time.perf_counter()
    for i in range(iters):
        out = step(st, thetas[i])
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return dt, flops_fn(st, m, n), type(st).__name__


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1024,2048,4096,8192")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--backends", default=None,
                    help="comma-separated subset to run")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    dtype = np.dtype(args.dtype).type
    enable_compile_cache()

    from tulip_tpu.kkt import (BandedK1Backend, DenseK1Backend,
                               SparseK1Backend, SparseK2Backend,
                               SplitK1Backend)

    kind = jax.devices()[0].device_kind
    peak = device_peaks(kind)["f64" if args.dtype == "float64" else "f32"]
    log(f"device: {kind}  platform: {jax.devices()[0].platform}  "
        f"count: {len(jax.devices())}  "
        f"{args.dtype} peak: {peak/1e12} TFLOP/s")

    rows = []
    hdr = (f"{'backend':>12} {'m':>6} {'ms':>9} {'GFLOP':>9} "
           f"{'GFLOP/s':>9} {'%peak':>7}")
    log(hdr)
    for m in sizes:
        A = staircase(m, dtype)
        Adc = np.array(A)  # dense-column variant for the SMW backend
        Adc[:, 7] = (np.random.default_rng(9)
                     .standard_normal(m).astype(dtype) * 0.5)
        cases = [
            ("dense", DenseK1Backend(inv_factor=True), A, flops_dense),
            ("banded", BandedK1Backend(min_block=128), A, flops_banded),
            ("sparse-128", SparseK1Backend(block=128), A, flops_sparse),
            ("sparse-smw", SplitK1Backend(block=128), Adc, flops_smw),
            ("sparse-ldl", SparseK2Backend(block=128), Adc,
             flops_sparse_ldl),
        ]
        for name, be, Ax, ffn in cases:
            if args.backends and name not in args.backends.split(","):
                continue
            dt, fl, stname = measure(be, Ax, ffn, iters=args.iters)
            if ("Dense" in stname) != (name == "dense"):
                log(f"{name:>12} {m:>6}  fell back to {stname}; skipped")
                continue
            gfs = fl / dt / 1e9
            pct = 100 * fl / dt / peak
            log(f"{name:>12} {m:>6} {dt*1e3:>9.2f} {fl/1e9:>9.2f} "
                f"{gfs:>9.1f} {pct:>7.2f}")
            rows.append(dict(backend=name, m=m, dtype=args.dtype,
                             ms=dt * 1e3, gflop=fl / 1e9, gflops=gfs,
                             pct_peak=pct, device=kind))
    print(json.dumps(rows))


if __name__ == "__main__":
    main()

"""Heterogeneous-batch bucketing benchmark (SURVEY §7 hard-part 5).

A size-skewed batch — many small LPs plus a few large outliers — solved
two ways on the default device:

  pad-to-max : every lane padded to the outlier envelope (round-2 behavior)
  bucketed   : pad-to-next-pow2 shape buckets, one compiled solve each
               (what batch_linprog now does)

Usage: python benchmarks/bench_buckets.py [n_small] [n_large]
"""

import os
import sys
import time

import jax

jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp
import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

from tulip_tpu.ipm.batch import (batched_hsd_solve, bucket_dim,  # noqa: E402
                                 stack_lps_host)
from tulip_tpu.ipm.hsd import HSDOptions  # noqa: E402
from tulip_tpu.kkt import DenseK1Backend  # noqa: E402
from tulip_tpu.utils import enable_compile_cache  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make(nb, m, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        out.append((A, A @ x0, rng.standard_normal(n), 0.0,
                    np.zeros(n), u))
    return out


def run(backend, opts, stacked):
    t0 = time.time()
    out = batched_hsd_solve(backend, opts, stacked)
    np.asarray(out.status)
    return time.time() - t0, out


def main():
    enable_compile_cache()
    n_small = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    n_large = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    small = make(n_small, 48, 96, 0)
    large = make(n_large, 128, 256, 1)
    tol = 3e-4
    opts = HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                      ToleranceRGap=tol, ToleranceIFeas=tol,
                      PRegMin=1e-6, DRegMin=1e-6)
    backend = DenseK1Backend(inv_factor=True, refinement_steps=1)
    dt = jnp.float32

    # pad-to-max: everything at the outlier envelope
    stacked_max = stack_lps_host(small + large, dtype=dt)
    log(f"pad-to-max envelope: {stacked_max.A.shape}")
    run(backend, opts, stacked_max)                 # compile
    t_max = min(run(backend, opts, stacked_max)[0] for _ in range(3))

    # bucketed: one solve per pow2 envelope
    buckets = {}
    for p in small + large:
        key = (bucket_dim(p[0].shape[0]), bucket_dim(p[0].shape[1]))
        buckets.setdefault(key, []).append(p)
    stacks = {k: stack_lps_host(v, dtype=dt, m_pad=k[0], n_pad=k[1])
              for k, v in sorted(buckets.items())}
    log(f"buckets: { {k: s.A.shape for k, s in stacks.items()} }")
    for s in stacks.values():
        run(backend, opts, s)                       # compile

    def run_buckets():
        t0 = time.time()
        outs = [batched_hsd_solve(backend, opts, s)
                for s in stacks.values()]
        for o in outs:
            np.asarray(o.status)
        return time.time() - t0

    t_buck = min(run_buckets() for _ in range(3))

    n_tot = n_small + n_large
    log(f"pad-to-max : {t_max:.3f}s  ({n_tot/t_max:.0f} solves/s)")
    log(f"bucketed   : {t_buck:.3f}s  ({n_tot/t_buck:.0f} solves/s)")
    log(f"speedup    : {t_max/t_buck:.2f}x")
    print({"pad_to_max_s": round(t_max, 4), "bucketed_s": round(t_buck, 4),
           "speedup": round(t_max / t_buck, 3)})


if __name__ == "__main__":
    main()

"""Benchmark: scenario-batched LP throughput on the local accelerator.

Solves a batch of random feasible standard-form LPs with the batched HSD
solver (f32 + one iterative-refinement sweep) and compares wall-clock
throughput against scipy's HiGHS (the strongest available CPU LP solver,
standing in for the reference CPU solver) solving the same instances at
MATCHED feasibility tolerances.

Prints the device (platform, kind, count, and the card's name and power
limit from nvidia-smi) on stderr, then ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

import json
import os
import sys
import time

import numpy as np

TOL = 3e-4  # f32 solve tolerance; HiGHS runs at the same feasibility tols.


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_raw_instances(nb, m, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        A = rng.standard_normal((m, n))
        u = rng.uniform(1.0, 4.0, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        b = A @ x0
        c = rng.standard_normal(n)
        out.append((A, b, c, u))
    return out


def bench_device(raws, dtype="float32", tol=TOL):
    import jax
    import jax.numpy as jnp

    from tulip_tpu.ipm.batch import batched_hsd_solve, stack_lps_host
    from tulip_tpu.ipm.hsd import HSDOptions
    from tulip_tpu.kkt import DenseK1Backend
    from tulip_tpu.status import TerminationStatus

    dt = jnp.dtype(dtype)
    # Host-side batch assembly: one transfer per leaf instead of ~8*B tiny
    # transfers.
    dats = stack_lps_host(
        [(A, b, c, 0.0, np.zeros(len(c)), u) for (A, b, c, u) in raws],
        dtype=dt)
    backend = DenseK1Backend(
        inv_factor=True, refinement_steps=1 if dtype == "float32" else 0)
    opts = HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                      ToleranceRGap=tol, ToleranceIFeas=tol,
                      PRegMin=1e-6, DRegMin=1e-6)

    log(f"compiling batched solve: B={len(raws)} "
        f"m={raws[0][0].shape[0]} n={raws[0][0].shape[1]} {dtype} "
        f"on {jax.devices()[0].platform}")

    def run():
        t0 = time.time()
        out = batched_hsd_solve(backend, opts, dats)
        np.asarray(out.status)
        return time.time() - t0, out

    t_first, out = run()
    log(f"first call (incl. compile): {t_first:.2f}s")
    wall = min(run()[0] for _ in range(3))

    st = np.asarray(out.status)
    n_opt = int((st == int(TerminationStatus.OPTIMAL)).sum())
    iters = np.asarray(out.niter)
    log(f"solved {n_opt}/{len(raws)} optimal, "
        f"mean iters {iters.mean():.1f}, wall {wall:.3f}s")
    return len(raws) / wall, n_opt, out


def bench_highs(raws, n_sample=128, tol=TOL):
    """HiGHS at feasibility tolerances MATCHED to the device solve (a
    3e-4 f32 solve against HiGHS at its default ~1e-7 is not a like-for-
    like ratio)."""
    from scipy.optimize import linprog

    opts = {"primal_feasibility_tolerance": tol,
            "dual_feasibility_tolerance": tol}
    sample = raws[:n_sample]
    t0 = time.time()
    n_ok = 0
    for (A, b, c, u) in sample:
        r = linprog(c, A_eq=A, b_eq=b, bounds=[(0, ub) for ub in u],
                    method="highs", options=opts)
        n_ok += (r.status == 0)
    wall = time.time() - t0
    log(f"HiGHS(tol={tol}): {n_ok}/{len(sample)} optimal in {wall:.3f}s "
        f"({len(sample)/wall:.1f} solves/s)")
    return len(sample) / wall


def bench_kkt_mfu(m=8192):
    """Dense-K1 factorize+solve GFLOP/s on one card and its share of the
    card's f32 peak, plus the level-scheduled structured backend's
    wall-clock on the same matrix (see benchmarks/mfu.py for the full
    backend × size table)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "benchmarks"))
    from bench_sparse import staircase
    from mfu import flops_dense, flops_sparse, measure
    from card import device_peaks
    from tulip_tpu.kkt import DenseK1Backend, SparseK1Backend

    A = staircase(m, np.float32)
    dt, fl, _ = measure(DenseK1Backend(inv_factor=True), A, flops_dense,
                        iters=5)
    gfs = fl / dt / 1e9
    out = {"kkt_dense_gflops_m8192": gfs,
           "kkt_dense_pct_f32_peak": 100 * fl / dt / device_peaks()["f32"]}
    log(f"kkt mfu (dense m={m}): {gfs:.0f} GFLOP/s")
    dts, _, stname = measure(SparseK1Backend(block=128), A, flops_sparse,
                             iters=5)
    out["kkt_sparse_ms_m8192"] = dts * 1e3
    out["kkt_sparse_state"] = stname
    log(f"kkt sparse (m={m}, {stname}): {dts*1e3:.2f} ms "
        f"({dt/dts:.1f}x the dense time)")
    return out


def main():
    import jax

    from tulip_tpu.utils import enable_compile_cache

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "benchmarks"))
    from card import gpu_card_info

    enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": gpu_card_info()}
    log(f"device: {device}")

    NB = int(os.environ.get("BENCH_NB", "2048"))
    M, N = 48, 96
    raws = make_raw_instances(NB, M, N)

    highs_rate = bench_highs(raws)
    result = {"metric": "batched_lp_throughput", "unit": "solves/s",
              "device": device,
              "vs_baseline_note": (
                  f"HiGHS on {min(len(raws), 128)} of the same instances "
                  f"at matched feasibility tolerance {TOL}")}
    result.update(bench_kkt_mfu())
    rate, n_opt, _ = bench_device(raws)
    result["value"] = rate
    result["n_optimal"] = n_opt
    result["vs_baseline"] = rate / highs_rate
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

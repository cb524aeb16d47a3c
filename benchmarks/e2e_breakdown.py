"""Account for the m=8192 end-to-end `Model.optimize()` wall-clock: how
much of it is compile, host work and IPM iterations.

Phases measured on the default device:

1. COLD solve: full Model.optimize() with per-phase `Model.timings`.
2. WARM re-solve: second optimize() on a fresh Model with identical
   shapes — in-process XLA executable-cache hits, so the delta cold−warm
   is almost pure XLA compile + first-dispatch latency.
3. Host-driven iteration loop (OutputLevel path): per-IPM-iteration
   wall-clock, isolating steady-state iteration cost from everything
   else.

Emits one JSON list on stdout.
"""

import json
import sys
import time

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(m=8192, sparse_first=None, label="auto"):
    import tulip_tpu as tlp
    from golden_large import multiperiod_lp, load_model

    A, b, c, u = multiperiod_lp(m)

    out = {"m": m, "route": label}

    # -- cold ------------------------------------------------------------
    mod = load_model(A, b, c, u, name=f"mp{m}")
    if sparse_first is not None:
        mod.params.KKT.SparseFirst = sparse_first
    t0 = time.time()
    st = mod.optimize()
    cold = time.time() - t0
    out["status"] = str(st)
    out["backend"] = mod.kkt_backend.name
    out["iters"] = mod.barrier_iterations
    out["cold_s"] = round(cold, 2)
    out["timings_cold"] = {k: round(v, 3) for k, v in mod.timings.items()}
    z = tlp.get_attribute(mod, "ObjectiveValue")
    out["objective"] = z
    log(f"[{label}] cold: {cold:.1f}s status={st} "
        f"backend={mod.kkt_backend.name} iters={mod.barrier_iterations}")
    log(f"[{label}] cold timings: {out['timings_cold']}")

    # -- warm ------------------------------------------------------------
    mod2 = load_model(A, b, c, u, name=f"mp{m}w")
    if sparse_first is not None:
        mod2.params.KKT.SparseFirst = sparse_first
    t0 = time.time()
    st2 = mod2.optimize()
    warm = time.time() - t0
    out["warm_s"] = round(warm, 2)
    out["timings_warm"] = {k: round(v, 3) for k, v in mod2.timings.items()}
    out["compile_plus_first_dispatch_s"] = round(
        out["timings_cold"].get("ipm", 0.0)
        - out["timings_warm"].get("ipm", 0.0), 2)
    log(f"[{label}] warm: {warm:.1f}s (ipm {out['timings_warm'].get('ipm')})"
        f" -> compile+first-dispatch ≈ "
        f"{out['compile_plus_first_dispatch_s']}s")

    # -- per-iteration (host-driven loop; separate jit program) ----------
    mod3 = load_model(A, b, c, u, name=f"mp{m}i")
    if sparse_first is not None:
        mod3.params.KKT.SparseFirst = sparse_first
    iter_times = []
    t_last = [None]

    def log_fn(state):
        now = time.time()
        if t_last[0] is not None:
            iter_times.append(now - t_last[0])
        t_last[0] = now

    # Route through the model's backend selection, then call hsd directly.
    from tulip_tpu.ipm.hsd import HSDOptions, hsd_solve

    # Reuse the model plumbing to build dat + backend exactly as optimize
    # does: run with IterationsLimit=0 to set kkt_backend, then solve by
    # hand with a log_fn.
    mod3.params.IPM.IterationsLimit = 0
    mod3.optimize()
    backend = mod3.kkt_backend
    dtype = np.dtype(mod3.params.ArithmeticDtype)
    pb_ = mod3.presolve_data.extract_reduced_arrays()
    from tulip_tpu.ipm.sparse_data import sparse_lp_data_from_problem
    from tulip_tpu.ipm.data import lp_data_from_problem
    if not hasattr(backend, "name"):
        raise RuntimeError
    if backend.name == "sparse" and (sparse_first is not False):
        res = sparse_lp_data_from_problem(pb_, dtype=dtype)
        dat = res[0]
    else:
        dat, _, _ = lp_data_from_problem(pb_, dtype=dtype)
    ipm_opts = mod3.params.IPM.resolved(dtype)
    opts = HSDOptions(
        TolerancePFeas=ipm_opts.TolerancePFeas,
        ToleranceDFeas=ipm_opts.ToleranceDFeas,
        ToleranceRGap=ipm_opts.ToleranceRGap,
        ToleranceIFeas=ipm_opts.ToleranceIFeas,
        IterationsLimit=100,
        CorrectionLimit=ipm_opts.CorrectionLimit,
        StepDampFactor=ipm_opts.StepDampFactor,
        GammaMin=ipm_opts.GammaMin,
        CentralityOutlierThreshold=ipm_opts.CentralityOutlierThreshold,
        PRegMin=ipm_opts.PRegMin,
        DRegMin=ipm_opts.DRegMin,
    )
    t0 = time.time()
    state = hsd_solve(dat, backend, opts, log_fn=log_fn)
    loop_total = time.time() - t0
    niter = int(state.niter)
    if iter_times:
        arr = np.asarray(iter_times[1:] or iter_times)
        out["iter_loop_total_s"] = round(loop_total, 2)
        out["iter_first_s"] = round(iter_times[0], 3)
        out["iter_median_s"] = round(float(np.median(arr)), 4)
        out["iter_p90_s"] = round(float(np.percentile(arr, 90)), 4)
        out["iter_count"] = niter
        log(f"[{label}] per-iteration: first {iter_times[0]:.2f}s "
            f"(iteration-program compile), median "
            f"{out['iter_median_s']*1e3:.1f}ms over {niter} iters; "
            f"loop total {loop_total:.1f}s")
    return out


def main():
    import jax
    jax.config.update("jax_enable_x64", True)
    from tulip_tpu.utils import enable_compile_cache

    enable_compile_cache()
    log("devices:", jax.devices())
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    results = [run(m, label="auto (sparse-first)")]
    # The dense standard form + probe route for comparison (banded
    # backend on this instance).
    results.append(run(m, sparse_first=False, label="dense-A route"))
    print(json.dumps(results))


if __name__ == "__main__":
    main()

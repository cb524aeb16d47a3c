"""Smoke run of the solver on NVIDIA GPUs, through the entry points a user
calls, each result checked against an independent reference.

One card (the default) runs phases 1-6:

1. device: platform, kind, count, the card, and the native libraries;
2. the card-only tests (``pytest -m gpu``), in a child process started
   before this process imports JAX, so one process holds the card at a time;
3. the CLI (``tulip_tpu.cli``) on the MPS fixtures and on an m=2048
   staircase written as ``.mps.gz``;
4. ``Model.optimize`` on the m=4096 staircase (dense-A route with the
   structure probe), objective against scipy's HiGHS;
5. ``Model.optimize`` on the m=32768 staircase (sparse-first route, the
   whole-solve ``while_loop``), checked by an independent host-side residual
   and gap check in float64;
6. ``batch_linprog`` on 2048 random 48x96 LPs in f32, objectives against
   HiGHS, with the device time of XLA's batched Cholesky + triangular
   inverse read from a profiler trace.

``--four-cards`` runs only the multi-device paths, on a 1-D mesh over four
cards: a sharded batch of LPs against a one-card solve, and a block-angular
two-stage LP with its scenario blocks sharded (Schur backend) against the
one-card dense solve, with a check that no collective in the compiled
iteration moves more than the n0 x n0 Schur block.

Each phase prints one line: status, error against its reference, compile
and solve seconds, and the card's name and power limit. The last line of
stdout is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The script exits non-zero, printing no such line, when JAX finds no GPU or
any phase fails.

Usage, from the repo root::

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NATIVE_LIBS = ("libtulip_mps.so", "libtulip_symbolic.so",
               "libtulip_presolve.so")

_compile_s = [0.0]          # trace + lower + backend compile, all programs


def _on_duration(event, secs, **_):
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += secs


@contextlib.contextmanager
def timed(out):
    """Add to ``out`` the compile seconds JAX reported inside the block
    and the rest of its wall seconds as solve seconds."""
    c0, t0 = _compile_s[0], time.perf_counter()
    yield
    compile_s = _compile_s[0] - c0
    out["compile_s"] = out.get("compile_s", 0.0) + compile_s
    out["solve_s"] = (out.get("solve_s", 0.0)
                      + time.perf_counter() - t0 - compile_s)


def report(phase, card, status="OK", **fields):
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {status} {kv} card=\"{card}\"", flush=True)


# ---------------------------------------------------------------------------
# Instances and independent checks
# ---------------------------------------------------------------------------

def staircase(m, seed=0):
    """The multiperiod staircase of examples/large_sparse.py: (A csr, b, c,
    u) with m rows, m/64*96 + 96 columns, rows b = A x0, bounds 0 <= x <= u."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from large_sparse import staircase as make

    return make(m, seed=seed)


def load_staircase(A, b, c, u, name):
    import tulip_tpu as tlp

    mod = tlp.Model()
    coo = A.tocoo()
    n = A.shape[1]
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data),
                    b, b, np.zeros(n), u, name=name)
    return mod


def highs_objective(A, b, c, u, tol=None):
    from scipy.optimize import linprog

    opts = ({} if tol is None else
            {"primal_feasibility_tolerance": tol,
             "dual_feasibility_tolerance": tol})
    r = linprog(c, A_eq=A, b_eq=b, bounds=np.stack([np.zeros_like(u), u], 1),
                method="highs", options=opts)
    if r.status != 0:
        raise AssertionError(f"HiGHS did not solve the reference: {r.message}")
    return float(r.fun)


def _finite(v):
    return np.where(np.isfinite(v), v, 0.0)


def host_check(A, lcon, ucon, lvar, uvar, c, sol):
    """Relative residuals of a claimed optimal primal-dual pair of
    ``min c x  s.t.  lcon <= A x <= ucon,  lvar <= x <= uvar``, computed in
    float64 on the host from the data alone: (primal, bound, dual, gap).

    Duals follow the solver's Solution: c = Aᵀ(y_lower − y_upper) +
    (s_lower − s_upper), every multiplier nonnegative and zero on an
    infinite bound."""
    x = np.asarray(sol.x, float)
    yl, yu = np.asarray(sol.y_lower, float), np.asarray(sol.y_upper, float)
    sl, su = np.asarray(sol.s_lower, float), np.asarray(sol.s_upper, float)
    scale_b = 1.0 + max(np.abs(_finite(lcon)).max(initial=0.0),
                        np.abs(_finite(ucon)).max(initial=0.0))
    scale_u = 1.0 + max(np.abs(_finite(lvar)).max(initial=0.0),
                        np.abs(_finite(uvar)).max(initial=0.0))
    scale_c = 1.0 + np.abs(c).max(initial=0.0)
    Ax = A @ x
    primal = max(np.max(lcon - Ax, initial=0.0),
                 np.max(Ax - ucon, initial=0.0), 0.0) / scale_b
    bound = max(np.max(lvar - x, initial=0.0),
                np.max(x - uvar, initial=0.0), 0.0) / scale_u
    r = c - A.T @ (yl - yu) - (sl - su)
    misplaced = max(
        np.max(-np.concatenate([yl, yu, sl, su]), initial=0.0),
        np.max(np.abs(yl[~np.isfinite(lcon)]), initial=0.0),
        np.max(np.abs(yu[~np.isfinite(ucon)]), initial=0.0),
        np.max(np.abs(sl[~np.isfinite(lvar)]), initial=0.0),
        np.max(np.abs(su[~np.isfinite(uvar)]), initial=0.0))
    dual = max(np.abs(r).max(initial=0.0), misplaced) / scale_c
    pobj = float(c @ x)
    dobj = float(_finite(lcon) @ yl - _finite(ucon) @ yu
                 + _finite(lvar) @ sl - _finite(uvar) @ su)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    return {"primal": primal, "bound": bound, "dual": dual, "gap": gap}


def farkas_check(A, lcon, ucon, lvar, uvar, sol):
    """Relative residual of a claimed primal-infeasibility certificate:
    Aᵀy + s = 0 with positive dual objective (every multiplier nonnegative,
    zero on an infinite bound). Returns (residual, dual objective), both
    relative to the certificate's size."""
    yl, yu = np.asarray(sol.y_lower, float), np.asarray(sol.y_upper, float)
    sl, su = np.asarray(sol.s_lower, float), np.asarray(sol.s_upper, float)
    size = max(np.abs(np.concatenate([yl, yu, sl, su])).max(initial=0.0),
               1e-300)
    resid = A.T @ (yl - yu) + (sl - su)
    misplaced = max(
        np.max(-np.concatenate([yl, yu, sl, su]), initial=0.0),
        np.max(np.abs(yl[~np.isfinite(lcon)]), initial=0.0),
        np.max(np.abs(yu[~np.isfinite(ucon)]), initial=0.0),
        np.max(np.abs(sl[~np.isfinite(lvar)]), initial=0.0),
        np.max(np.abs(su[~np.isfinite(uvar)]), initial=0.0))
    dobj = float(_finite(lcon) @ yl - _finite(ucon) @ yu
                 + _finite(lvar) @ sl - _finite(uvar) @ su)
    return max(np.abs(resid).max(initial=0.0), misplaced) / size, dobj / size


def problem_arrays(pb):
    """(A csr, lcon, ucon, lvar, uvar, c) of a ProblemData, min sense."""
    import scipy.sparse as sp

    if not pb.objsense:
        raise ValueError("the host checks take minimization problems")
    I, J, V = pb.to_coo()
    A = sp.csr_matrix((V, (I, J)), shape=(pb.ncon, pb.nvar))
    return (A, np.asarray(pb.lcon, float), np.asarray(pb.ucon, float),
            np.asarray(pb.lvar, float), np.asarray(pb.uvar, float),
            np.asarray(pb.obj, float))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def native_status():
    """Which native libraries were built now, loaded as they were, or are
    unavailable."""
    from tulip_tpu.io import native as io_native
    from tulip_tpu.kkt import native as kkt_native
    from tulip_tpu.presolve import native as presolve_native

    path = os.path.join(REPO, "native", "build")

    def mtime(lib):
        p = os.path.join(path, lib)
        return os.path.getmtime(p) if os.path.exists(p) else None

    before = {lib: mtime(lib) for lib in NATIVE_LIBS}
    avail = dict(zip(NATIVE_LIBS, (io_native.native_available(),
                                   kkt_native.native_available(),
                                   presolve_native.native_available())))
    return {lib: ("unavailable" if not avail[lib] else
                  "built" if mtime(lib) != before[lib] else "loaded")
            for lib in NATIVE_LIBS}


def phase_gpu_tests(timeout=900):
    """``pytest -m gpu`` in a child process on the card: every card-only
    test must run and pass (a skip means the child found no card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
         "-o", "addopts=", "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    n_pass = re.search(r"(\d+) passed", tail)
    if (r.returncode != 0 or n_pass is None
            or re.search(r"skipped|failed|error", tail)):
        raise AssertionError(
            f"pytest -m gpu: rc={r.returncode} {tail!r}\n"
            f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return {"passed": int(n_pass.group(1))}


def phase_cli(m_stair=2048):
    """The CLI on the optimal and the infeasible fixture, and on a seeded
    staircase written as .mps.gz (MPC). Returns the worst relative error."""
    import tulip_tpu as tlp
    import tulip_tpu.cli as cli
    from tulip_tpu.io.mps import write_mps
    from tulip_tpu.solution import SolutionStatus
    from tulip_tpu.status import TerminationStatus

    out = {}

    def run(argv):
        log = io.StringIO()
        with contextlib.redirect_stdout(log), timed(out):
            rc, mod = cli.run(argv)
        return rc, mod, log.getvalue()

    rc, mod, log = run([os.path.join(REPO, "tests/data/lp_opt.mps")])
    z = tlp.get_attribute(mod, "ObjectiveValue") if rc == 0 else None
    if rc != 0 or abs(z - 1.5) > 1e-7:
        raise AssertionError(f"lp_opt.mps: rc={rc} z={z}\n{log}")
    err_opt = abs(z - 1.5) / 1.5

    rc, mod, log = run([os.path.join(REPO, "tests/data/lp_inf.mps")])
    sol = mod.solution
    if (rc != 1 or mod.status != TerminationStatus.PRIMAL_INFEASIBLE
            or not sol.is_dual_ray
            or sol.dual_status
            != SolutionStatus.INFEASIBILITY_CERTIFICATE):
        raise AssertionError(
            f"lp_inf.mps: rc={rc} status={mod.status.name} "
            f"ray={sol.is_dual_ray}\n{log}")
    A, lcon, ucon, lvar, uvar, _ = problem_arrays(mod.pbdata)
    resid, dobj = farkas_check(A, lcon, ucon, lvar, uvar, sol)
    if resid > 1e-6 or dobj <= 1e-9:
        raise AssertionError(f"lp_inf.mps certificate: residual "
                             f"{resid:.3e}, dual objective {dobj:.3e}")

    A, b, c, u = staircase(m_stair, seed=1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"stair{m_stair}.mps.gz")
        write_mps(load_staircase(A, b, c, u, f"stair{m_stair}").pbdata,
                  path)
        rc, mod, log = run(["--Method", "MPC", path])
    z = tlp.get_attribute(mod, "ObjectiveValue") if rc == 0 else None
    z_ref = highs_objective(A, b, c, u)
    err_stair = (abs(z - z_ref) / max(1.0, abs(z_ref))
                 if z is not None else float("inf"))
    if rc != 0 or err_stair > 1e-7:
        raise AssertionError(f"staircase m={m_stair} .mps.gz MPC: rc={rc}"
                             f" z={z} HiGHS {z_ref}\n{log}")
    out.update(err=max(err_opt, err_stair), farkas_resid=resid,
               staircase_backend=mod.kkt_backend.name)
    return out


def phase_mid(m=4096):
    """Model.optimize on the staircase in f64 at the default tolerances;
    the structure probe picks the backend. Objective against HiGHS."""
    import tulip_tpu as tlp
    from tulip_tpu.status import TerminationStatus

    A, b, c, u = staircase(m)
    mod = load_staircase(A, b, c, u, f"stair{m}")
    out = {}
    with timed(out):
        st = mod.optimize()
    if st != TerminationStatus.OPTIMAL:
        raise AssertionError(f"m={m}: {st.name}")
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_objective(A, b, c, u)
    err = abs(z - z_ref) / max(1.0, abs(z_ref))
    if err > 1e-7:
        raise AssertionError(f"m={m}: objective {z} vs HiGHS {z_ref}")
    out.update(err=err, backend=mod.kkt_backend.name,
               iters=mod.barrier_iterations)
    return out


@contextlib.contextmanager
def capture_solve_args():
    """Record the arguments of the whole-solve program that
    ``hsd_solve`` runs, so its compiled memory can be read afterwards."""
    from tulip_tpu.ipm import hsd

    seen = []
    orig = hsd.hsd_solve_device

    def recording(*args):
        seen.append(args)
        return orig(*args)

    hsd.hsd_solve_device = recording
    try:
        yield seen, orig
    finally:
        hsd.hsd_solve_device = orig


def phase_large(m=32768, sparse_first=None):
    """Model.optimize on the large staircase: the sparse-first data path
    and the whole-solve while_loop. Checked on the host from the COO data
    and the returned x, y, s; HiGHS takes hours at this size."""
    import jax

    from tulip_tpu.status import TerminationStatus

    A, b, c, u = staircase(m)
    mod = load_staircase(A, b, c, u, f"stair{m}")
    if sparse_first is not None:
        mod.params.KKT.SparseFirst = sparse_first
    out = {"n": A.shape[1], "nnz": A.nnz}
    with capture_solve_args() as (seen, program), timed(out):
        st = mod.optimize()
    if st != TerminationStatus.OPTIMAL:
        raise AssertionError(f"m={m}: {st.name}")
    if len(seen) != 1 or hasattr(seen[0][2], "A"):
        raise AssertionError(f"m={m} did not run the sparse-first "
                             f"whole-solve program ({len(seen)} calls)")
    n = A.shape[1]
    errs = host_check(A, b, b, np.zeros(n), u, c, mod.solution)
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"m={m}: host check {errs}")
    mem = program.lower(*seen[0]).compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    out.update(err=max(errs.values()), **{f"err_{k}": v
                                          for k, v in errs.items()},
               backend=mod.kkt_backend.name, iters=mod.barrier_iterations,
               temp_bytes=getattr(mem, "temp_size_in_bytes", None),
               argument_bytes=getattr(mem, "argument_size_in_bytes", None),
               output_bytes=getattr(mem, "output_size_in_bytes", None),
               peak_bytes_in_use=stats.get("peak_bytes_in_use"),
               timings={k: round(v, 3) for k, v in mod.timings.items()})
    return out


CHOL_TRSM = re.compile(r"potrf|cholesky|trsm|triangular", re.I)


def device_events(trace_dir):
    """(name, start_ns, end_ns) of every event on the GPU device planes of
    the newest trace under ``trace_dir``; the name joins the kernel name
    with the HLO op it came from."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise AssertionError(f"no trace under {trace_dir}")
    prof = ProfileData.from_file(paths[-1])
    events = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                hlo = " ".join(str(v) for k, v in ev.stats
                               if k in ("hlo_op", "tf_op", "name"))
                events.append((f"{ev.name} {hlo}", ev.start_ns, ev.end_ns))
    return events


def union_ns(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_share(events, pattern=CHOL_TRSM):
    """(matched busy ns, all busy ns, top kernels by time) over device
    events; busy time is the union of the events' intervals."""
    matched = [(s, e) for name, s, e in events if pattern.search(name)]
    by_name = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return union_ns(matched), union_ns([(s, e) for _, s, e in events]), top


def phase_batch(nb=2048, m=48, n=96, n_highs=32, tol=3e-4, trace_dir=None):
    """batch_linprog in f32 at ``tol``: every lane OPTIMAL, objectives
    against HiGHS at matched feasibility tolerances on ``n_highs`` sampled
    instances. With ``trace_dir``, a second (warm) solve is traced and the
    device time of the batched Cholesky + triangular solves is read."""
    import jax

    import tulip_tpu as tlp

    from bench import make_raw_instances

    lps = make_raw_instances(nb, m, n)
    problems = [dict(c=c, A_eq=A, b_eq=b,
                     bounds=np.stack([np.zeros(n), u], 1))
                for A, b, c, u in lps]
    params = tlp.Parameters()
    for k in ("TolerancePFeas", "ToleranceDFeas", "ToleranceRGap",
              "ToleranceIFeas"):
        setattr(params.IPM, k, tol)
    out = {}
    with timed(out):
        res = tlp.batch_linprog(problems, dtype="float32", params=params)
    bad = [i for i, r in enumerate(res) if not r.success]
    if bad:
        raise AssertionError(f"{len(bad)}/{nb} lanes not OPTIMAL: "
                             f"{[res[i].termination.name for i in bad[:5]]}")
    pick = np.random.default_rng(1).choice(nb, size=min(n_highs, nb),
                                           replace=False)
    err = max(abs(res[i].fun - z) / max(1.0, abs(z))
              for i in pick
              for z in [highs_objective(*lps[i], tol=tol)])
    if err > 1e-3:
        raise AssertionError(f"batch objectives vs HiGHS: {err:.3e}")
    nit = np.array([r.nit for r in res])
    out.update(err=err, solves_per_s=nb / (out["compile_s"] + out["solve_s"]),
               iters_mean=float(nit.mean()), iters_max=int(nit.max()))
    if trace_dir is not None:
        # Device activity only: the Python tracer would record every call
        # of the 2048 host-side presolves.
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        opts.host_tracer_level = 1
        with jax.profiler.trace(trace_dir, profiler_options=opts):
            tlp.batch_linprog(problems, dtype="float32", params=params)
        chol, busy, top = kernel_share(device_events(trace_dir))
        if busy <= 0:
            raise AssertionError("no device events in the trace")
        out.update(chol_trsm_ms_per_iter=chol / 1e6 / nit.max(),
                   chol_trsm_share=chol / busy,
                   device_busy_ms=busy / 1e6,
                   top_kernels=[(k[:80], round(v / 1e6, 3)) for k, v in top])
    return out


def two_stage(K, seed, dims, dtype):
    """Feasible bounded two-stage block-angular LP with K scenario blocks:
    dims = (m0, n0, mk, nk)."""
    import jax.numpy as jnp

    from tulip_tpu.parallel import make_block_angular

    rng = np.random.default_rng(seed)
    m0, n0, mk, nk = dims
    A0 = rng.standard_normal((m0, n0))
    T = rng.standard_normal((K, mk, n0))
    W = rng.standard_normal((K, mk, nk))
    u0 = rng.uniform(1, 3, n0)
    uk = rng.uniform(1, 3, (K, nk))
    x0, xs = u0 * 0.5, uk * 0.5
    return make_block_angular(
        A0, A0 @ x0, rng.standard_normal(n0), T, W,
        np.einsum("kij,j->ki", T, x0) + np.einsum("kij,kj->ki", W, xs),
        rng.standard_normal((K, nk)),
        np.zeros(n0 + K * nk), np.concatenate([u0, uk.reshape(-1)]),
        dtype=jnp.dtype(dtype))


def collective_sizes(hlo_text):
    """(kind, element count) of every collective in compiled HLO text."""
    out = []
    for line in re.finditer(r"[^\n]*(all-reduce|all-gather|reduce-scatter|"
                            r"all-to-all|collective-permute)\([^\n]*",
                            hlo_text):
        shp = re.search(r"(?:f|s|u|pred)\d*\[([\d,]*)\]", line.group(0))
        if shp is not None:
            dims = [int(x) for x in shp.group(1).split(",") if x]
            out.append((line.group(1), int(np.prod(dims)) if dims else 1))
    return out


def phase_multi_batch(devices, per_device=512, m=48, n=96, tol=3e-4):
    """A batch sharded over a 1-D mesh of ``devices`` with shard_batch:
    every lane OPTIMAL, objectives equal to a one-device solve."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tulip_tpu.ipm.batch import (batched_hsd_solve, shard_batch,
                                     stack_lps_host)
    from tulip_tpu.ipm.hsd import HSDOptions
    from tulip_tpu.kkt import DenseK1Backend
    from tulip_tpu.status import TerminationStatus

    nb = per_device * len(devices)
    from bench import make_raw_instances

    dats = stack_lps_host([(A, b, c, 0.0, np.zeros(n), u) for A, b, c, u
                           in make_raw_instances(nb, m, n, seed=3)],
                          dtype=jnp.float32)
    backend = DenseK1Backend(inv_factor=True, refinement_steps=1)
    opts = HSDOptions(TolerancePFeas=tol, ToleranceDFeas=tol,
                      ToleranceRGap=tol, ToleranceIFeas=tol,
                      PRegMin=1e-6, DRegMin=1e-6)
    mesh = Mesh(np.array(devices), ("batch",))
    out = {}
    with timed(out):
        sharded = jax.device_get(
            batched_hsd_solve(backend, opts, shard_batch(dats, mesh)))
    single = jax.device_get(batched_hsd_solve(
        backend, opts, jax.device_put(dats, devices[0])))
    st = np.asarray(sharded.status)
    if not (st == int(TerminationStatus.OPTIMAL)).all():
        raise AssertionError(f"sharded batch: {(st != 2).sum()} lanes not "
                             "OPTIMAL")
    z, z1 = np.asarray(sharded.pobj), np.asarray(single.pobj)
    err = float(np.max(np.abs(z - z1) / np.maximum(1.0, np.abs(z1))))
    # The sharded program may pick other batched kernels than the
    # one-device program; f32 rounding then lets a lane stop one iteration
    # earlier or later, anywhere inside the 3e-4 tolerance. So lanes agree
    # to the tolerance the solve was asked for, with the margin phase 6
    # allows against HiGHS.
    if err > 1e-3:
        raise AssertionError(f"sharded vs one-device objectives: {err:.3e}")
    out.update(err=err, lanes=nb,
               lanes_bitwise_equal=int((z == z1).sum()),
               lanes_same_iters=int((np.asarray(sharded.niter)
                                     == np.asarray(single.niter)).sum()))
    return out


def phase_multi_schur(devices, K=64, dims=(8, 128, 128, 256)):
    """A two-stage LP with K scenario blocks sharded over a 1-D mesh of
    ``devices`` (Schur backend, f64, default tolerances) against the
    one-device dense solve; no collective of the compiled iteration may
    move more than the n0 x n0 Schur block."""
    import jax
    from jax.sharding import Mesh

    from tulip_tpu.ipm.hsd import (HSDOptions, hsd_iteration,
                                   hsd_solve_device, init_state)
    from tulip_tpu.kkt import DenseK1Backend, SchurK1Backend
    from tulip_tpu.parallel import block_angular_to_dense, shard_scenarios
    from tulip_tpu.status import TerminationStatus

    n0 = dims[1]
    ba = two_stage(K, seed=11, dims=dims, dtype="float64")
    mesh = Mesh(np.array(devices), ("scen",))
    sharded = shard_scenarios(ba, mesh)
    backend, opts = SchurK1Backend(), HSDOptions()

    step = jax.jit(lambda d, s: hsd_iteration(backend, opts, d, s))
    state0 = jax.jit(lambda d: init_state(d, backend))(sharded)
    colls = collective_sizes(step.lower(sharded, state0).compile().as_text())
    if not colls:
        raise AssertionError("no collectives in the sharded iteration")
    largest = max(size for _, size in colls)
    if largest > n0 * n0:
        raise AssertionError(f"a collective moves {largest} elements, more "
                             f"than the {n0}x{n0} Schur block")

    out = {}
    with timed(out):
        res = jax.block_until_ready(hsd_solve_device(backend, opts, sharded))
    if int(res.status) != int(TerminationStatus.OPTIMAL):
        raise AssertionError(f"sharded Schur solve: status {int(res.status)}")
    dense = jax.device_put(block_angular_to_dense(ba), devices[0])
    ref = hsd_solve_device(DenseK1Backend(), opts, dense)
    if int(ref.status) != int(TerminationStatus.OPTIMAL):
        raise AssertionError(f"one-device dense solve: {int(ref.status)}")
    z, z_ref = float(res.pobj), float(ref.pobj)
    err = abs(z - z_ref) / max(1.0, abs(z_ref))
    if err > 1e-7:
        raise AssertionError(f"Schur {z} vs dense {z_ref}: {err:.3e}")
    out.update(err=err, collectives=len(colls), largest_collective=largest,
               iters=int(res.niter))
    return out


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def result_line(devices):
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def run_phase(name, card, fn, *args, **kwargs):
    """Run one phase and print its line; ``wall_s`` includes building the
    instance and checking the result."""
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    except BaseException as e:
        report(name, card, status="FAIL",
               error=repr(f"{type(e).__name__}: {e}"[:2000]))
        raise
    report(name, card, **out, wall_s=time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths on four cards")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "tulip_tpu")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from card import gpu_card_info

    try:
        card = gpu_card_info().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke.py: no NVIDIA GPU ({e})", file=sys.stderr)
        return 2
    print(card, flush=True)

    n_cards = 4 if args.four_cards else 1
    if not args.four_cards:
        run_phase("gpu-tests", card, phase_gpu_tests)

    import jax

    from tulip_tpu.utils import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: JAX runs on {devices[0].platform}, not a GPU",
              file=sys.stderr)
        return 2
    if len(devices) < n_cards:
        print(f"chip_smoke.py: needs {n_cards} GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:n_cards]
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    cache = enable_compile_cache()
    report("device", card, platform=devices[0].platform,
           kind=repr(devices[0].device_kind), count=len(devices),
           compile_cache=cache, native=native_status())

    if args.four_cards:
        run_phase("multi-batch", card, phase_multi_batch, devices)
        run_phase("multi-schur", card, phase_multi_schur, devices)
    else:
        run_phase("cli", card, phase_cli)
        run_phase("mid-lp", card, phase_mid)
        run_phase("large-lp", card, phase_large)
        trace_dir = os.path.join(REPO, "chiprun_out", "chip_smoke_trace")
        run_phase("batch", card, phase_batch, trace_dir=trace_dir)

    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""User-facing Model and the optimize driver.

Orchestrates presolve → standard form → IPM → solution extraction →
postsolve (reference: src/model.jl:67-154).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ipm.data import lp_data_from_problem
from .ipm.hsd import HSDOptions, hsd_solve
from .ipm.mpc import MPCOptions, mpc_solve
from .kkt import make_backend
from .params import Parameters
from .presolve import PresolveData, postsolve
from .problem import ProblemData
from .solution import Solution
from .status import SolutionStatus, TerminationStatus


class Model:
    """LP model: parameters + problem data + (after optimize) solution
    (reference: src/model.jl:1-37)."""

    def __init__(self, params: Optional[Parameters] = None):
        self.params = params or Parameters()
        self.status = TerminationStatus.NOT_CALLED
        self.pbdata = ProblemData()
        self.presolve_data: Optional[PresolveData] = None
        self.solver_state = None  # final device-side IPM state
        self.solution: Optional[Solution] = None
        self.solve_time = 0.0
        self.barrier_iterations = 0
        self.kkt_backend = None  # backend instance used by the last solve
        self._probe_cache = None  # (pattern fingerprint, backend name)
        # Per-phase wall-clock timings (the reference's TimerOutputs
        # analogue, reference: src/IPM/HSD/HSD.jl:22, @timeit annotations):
        # presolve / standard_form / ipm / extract / postsolve seconds.
        self.timings: dict = {}

    def empty(self) -> None:
        """Reset to an empty model (reference: src/model.jl:52-60)."""
        self.pbdata = ProblemData()
        self.status = TerminationStatus.NOT_CALLED
        self.presolve_data = None
        self.solver_state = None
        self.solution = None
        self.solve_time = 0.0
        self.barrier_iterations = 0
        self._probe_cache = None

    # ------------------------------------------------------------------
    def optimize(self) -> TerminationStatus:
        """Solve the problem (reference: src/model.jl:67-154)."""
        import time
        t0 = time.time()
        self.timings = {}
        params = self.params
        pb = self.pbdata

        if params.OutputLevel > 0:
            print("\nProblem info")
            print(f"  Name        : {pb.name}")
            print(f"  Constraints : {pb.ncon}")
            print(f"  Variables   : {pb.nvar}")
            print(f"  Non-zeros   : {pb.nnz}")

        pb_ = pb
        self.presolve_data = None
        if params.Presolve.Level > 0:
            t_ = time.time()
            ps = PresolveData(pb, params.Presolve)
            engine = getattr(params.Presolve, "Engine", "auto")
            st = None
            if engine in ("auto", "native"):
                from .presolve.native import presolve_native
                st = presolve_native(ps)
                if st is None and engine == "native":
                    raise RuntimeError("native presolve engine unavailable")
            if st is None:
                st = ps.presolve()
            if st in (TerminationStatus.PRIMAL_INFEASIBLE,
                      TerminationStatus.DUAL_INFEASIBLE):
                # Cheap witness scan for the OTHER side's infeasibility
                # (beyond reference: Trm_PrimalDualInfeasible is defined
                # but never produced there, src/status.jl:22).
                st = ps.upgrade_if_both_infeasible()
            self.timings["presolve"] = time.time() - t_
            self.presolve_data = ps
            if st in (TerminationStatus.OPTIMAL,
                      TerminationStatus.PRIMAL_INFEASIBLE,
                      TerminationStatus.DUAL_INFEASIBLE,
                      TerminationStatus.PRIMAL_DUAL_INFEASIBLE):
                # Presolve solved the problem (reference: model.jl:105-119).
                sol0 = Solution(pb.ncon, pb.nvar)
                postsolve(sol0, ps.solution, ps)
                _validate_certificates(pb, sol0,
                                       tol=_certificate_tol(params))
                self.solution = sol0
                self.status = st
                self.solve_time = time.time() - t0
                return self.status
            pb_ = ps.extract_reduced_arrays()
            if params.OutputLevel > 0:
                print("\nReduced problem info")
                print(f"  Constraints : {ps.nrow}  "
                      f"(removed {pb.ncon - ps.nrow})")
                print(f"  Variables   : {ps.ncol}  "
                      f"(removed {pb.nvar - ps.ncol})")
                print(f"  Non-zeros   : {pb_.nnz}")

        if pb_.nvar == 0 or pb_.ncon == 0:
            # Degenerate shapes the IPM cannot take (no variables / no
            # rows): closed-form solve. Presolve catches these when on
            # (reference: Presolve.jl:442-454); with presolve off the
            # zero-size arrays must not reach the device path.
            sol_inner, st = _trivial_solve(pb_)
            self.barrier_iterations = 0
            if params.Presolve.Level > 0:
                sol_outer = Solution(pb.ncon, pb.nvar)
                postsolve(sol_outer, sol_inner, self.presolve_data)
                self.solution = sol_outer
            else:
                self.solution = sol_inner
            _validate_certificates(pb, self.solution,
                                   tol=_certificate_tol(params))
            self.status = st
            self.solve_time = time.time() - t0
            return self.status

        t_ = time.time()
        dtype = np.dtype(params.ArithmeticDtype)
        backend_name = params.KKT.Backend
        dat = None
        # Sparse-first route: assemble standard form straight from COO into
        # support-compressed tiles — the dense (m, n) array is never built,
        # so problem size is bounded by O(nnz + m·smax) instead of O(m·n)
        # (the CHOLMOD-at-any-scale role, reference:
        # src/KKT/Cholmod/sqd.jl:42-53, src/problemData.jl:43-44).
        if (params.KKT.SparseFirst is not False
                and params.KKT.System in (None, "K1")
                and backend_name in (None, "sparse", "sparse-smw")):
            from .ipm.sparse_data import (sparse_lp_data_from_problem,
                                          sparse_pattern_signals)
            attempt = params.KKT.SparseFirst is True
            if not attempt and pb_.ncon >= params.KKT.SparseFirstThreshold:
                sig = sparse_pattern_signals(pb_)
                # O(nnz) routing: sparse enough to tile. Dense columns
                # are allowed WITHIN the measured SMW regime (k <= 8 and
                # norm-dominance ratio <= 30, the round-4 smw-vs-K2 rule)
                # — they split out as the explicit U at the data level;
                # beyond that regime the direct K2 factorization is the
                # validated backend and rides the dense path.
                # Density pre-gate is deliberately loose (the symbolic
                # planner's fill/support gates are the real arbiters);
                # it only skips the O(nnz) symbolic attempt on problems
                # that obviously cannot tile.
                smw_ok = (sig["n_dense_cols"] == 0
                          or (sig["n_dense_cols"] <= 8
                              and sig["dense_norm_ratio"] <= 30.0))
                attempt = sig["density"] < 0.1 and smw_ok
            if attempt:
                res = sparse_lp_data_from_problem(pb_, dtype=dtype)
                if res is not None:
                    dat, n_struct, objsense = res
                    backend_name = ("sparse-smw" if dat.U.shape[1]
                                    else "sparse")
        if dat is None:
            dat, n_struct, objsense = lp_data_from_problem(pb_, dtype=dtype)
        self.timings["standard_form"] = time.time() - t_
        sparse_first = not hasattr(dat, "A")

        if backend_name is None and params.KKT.System in (None, "K1") \
                and dat.A.shape[0] >= 2048:
            # Large problem: probe for exploitable structure on the host.
            # The probe result is cached on the model keyed by a cheap
            # pattern fingerprint, so modify-objective/bounds →
            # re-optimize loops pay the O(mn) scan once; any edit that
            # changes the nonzero pattern changes the key.
            A_np = np.asarray(dat.A)
            nz = A_np != 0
            # The probe routes on VALUES too (dense-column norm-dominance
            # ratio -> sparse-ldl), so the key folds in a quantized value
            # signal: a value-only edit that pushes dense-column norms
            # into the measured SMW stall regime must re-probe, not reuse
            # a stale 'sparse-smw' decision.
            cnorm = np.linalg.norm(A_np, axis=0)
            med = float(np.median(cnorm[cnorm > 0])) if nz.any() else 1.0
            norm_sig = int(np.log2(max(float(cnorm.max()), 1e-300)
                                   / max(med, 1e-300)) * 4.0)
            key = (A_np.shape,
                   hash(nz.sum(axis=0).tobytes()),
                   hash(nz.sum(axis=1).tobytes()),
                   norm_sig)
            cached = getattr(self, "_probe_cache", None)
            if cached is not None and cached[0] == key:
                backend_name = cached[1]
            else:
                backend_name = _probe_structure(A_np)
                self._probe_cache = (key, backend_name)
        if backend_name is None and params.KKT.System == "K2" \
                and dat.A.shape[0] >= 2048:
            # Large problem on the augmented system: the tiled signed
            # blocked Cholesky exploits sparsity (CHOLMOD-on-K2 role,
            # reference default dispatch src/KKT/KKT.jl:134-141) and
            # falls back to dense-ldl internally when tiling gives no
            # advantage.
            backend_name = "sparse-ldl"
        ipm_opts = params.IPM.resolved(dtype)
        if backend_name is None and params.KKT.System in (None, "K1") \
                and dtype == np.float64 \
                and min(ipm_opts.TolerancePFeas, ipm_opts.ToleranceDFeas,
                        ipm_opts.ToleranceRGap,
                        ipm_opts.ToleranceIFeas) < 1e-9:
            # Tolerances beyond f64's sqrt(eps): plain f64 solves lose all
            # forward accuracy once cond(K) ~ 1/eps near convergence; use
            # double-double-residual refinement.
            backend_name = "extended"
        refinement = params.KKT.RefinementSteps
        if refinement is None:
            # Per-backend defaults, applied whether the backend was probed
            # or user-selected (round-4 fix: an explicit
            # KKT_Backend="sparse-smw" used to run with ZERO sweeps and
            # stall at ITERATION_LIMIT on LPs the probe-selected identical
            # backend solved in 13 iterations).
            # smw/ldl: SMW's forward error at late-IPM Θ needs two sweeps
            # on the true system to hold 1e-8 (measured: 25-27 IPM iters
            # at <=1 sweep vs 8 at 2).
            # extended/extended-dd: their dd-residual sweeps ARE the
            # sub-sqrt(eps) accuracy mechanism — zero sweeps would reduce
            # them to plain dense K1 (round-5 fix: make_backend always
            # passes refinement_steps, so the class defaults of 2/1 were
            # being silently overridden to 0 here).
            refinement = {"sparse-smw": 2, "sparse-ldl": 2, "extended": 2,
                          "extended-dd": 1}.get(backend_name or "", 0)
            if sparse_first:
                # Inverse-factor GEMM solves (level schedule) lose ~1-2
                # digits vs TRSM; one sweep on the true system restores
                # 1e-8-grade steps at any scale.
                refinement = max(refinement, 1)
        backend = make_backend(backend_name, params.KKT.System, refinement)
        # Introspection: which linear solver actually ran (the reference
        # prints this in the solver header, src/IPM/HSD/HSD.jl:214-230;
        # kept on the model so tests can assert auto-probe decisions).
        self.kkt_backend = backend

        import contextlib
        profile_ctx = contextlib.nullcontext()
        if params.ProfileDir:
            import jax
            profile_ctx = jax.profiler.trace(params.ProfileDir)

        algo = params.IPM.Algorithm.upper()
        try:
            state = self._run_ipm(algo, dat, backend, ipm_opts, params,
                                  profile_ctx)
        except KeyboardInterrupt:
            # User interrupt: keep whatever phase state exists, report
            # UNKNOWN instead of crashing (reference:
            # src/IPM/HSD/HSD.jl:330-333 InterruptException -> Trm_Unknown).
            self.status = TerminationStatus.UNKNOWN
            self.solve_time = time.time() - t0
            return self.status
        except Exception as e:
            if _is_oom(e):
                # Device memory exhausted mid-solve (reference:
                # HSD.jl:325-328 OutOfMemoryError -> Trm_MemoryLimit).
                self.status = TerminationStatus.MEMORY_LIMIT
                self.solve_time = time.time() - t0
                return self.status
            raise

        self.solver_state = state
        self.barrier_iterations = int(state.niter)

        # Extract solution in (reduced) original space.
        t_ = time.time()
        sol_inner = Solution(pb_.ncon, pb_.nvar)
        _extract_solution(sol_inner, pb_, state, n_struct)
        self.timings["extract"] = time.time() - t_

        if params.Presolve.Level > 0:
            t_ = time.time()
            sol_outer = Solution(pb.ncon, pb.nvar)
            postsolve(sol_outer, sol_inner, self.presolve_data)
            self.timings["postsolve"] = time.time() - t_
            self.solution = sol_outer
        else:
            self.solution = sol_inner
        _validate_certificates(pb, self.solution,
                               tol=_certificate_tol(params, dtype))

        self.status = TerminationStatus(int(state.status))
        self.solve_time = time.time() - t0
        return self.status

    def _run_ipm(self, algo, dat, backend, ipm_opts, params, profile_ctx):
        import time

        if algo == "HSD":
            opts = HSDOptions(
                TolerancePFeas=ipm_opts.TolerancePFeas,
                ToleranceDFeas=ipm_opts.ToleranceDFeas,
                ToleranceRGap=ipm_opts.ToleranceRGap,
                ToleranceIFeas=ipm_opts.ToleranceIFeas,
                IterationsLimit=ipm_opts.IterationsLimit,
                TimeLimit=ipm_opts.TimeLimit,
                CorrectionLimit=ipm_opts.CorrectionLimit,
                StepDampFactor=ipm_opts.StepDampFactor,
                GammaMin=ipm_opts.GammaMin,
                CentralityOutlierThreshold=ipm_opts.CentralityOutlierThreshold,
                PRegMin=ipm_opts.PRegMin,
                DRegMin=ipm_opts.DRegMin,
                OutputLevel=max(params.OutputLevel, ipm_opts.OutputLevel),
                MehrotraStart=ipm_opts.MehrotraStart,
                FastPredictor=ipm_opts.FastPredictor,
                FastCorrections=ipm_opts.FastCorrections,
            )
            t_ = time.time()
            with profile_ctx:
                state = hsd_solve(dat, backend, opts)
            self.timings["ipm"] = time.time() - t_
        elif algo == "MPC":
            opts = MPCOptions(
                TolerancePFeas=ipm_opts.TolerancePFeas,
                ToleranceDFeas=ipm_opts.ToleranceDFeas,
                ToleranceRGap=ipm_opts.ToleranceRGap,
                ToleranceIFeas=ipm_opts.ToleranceIFeas,
                IterationsLimit=ipm_opts.IterationsLimit,
                TimeLimit=ipm_opts.TimeLimit,
                CorrectionLimit=ipm_opts.CorrectionLimit,
                StepDampFactor=ipm_opts.StepDampFactor,
                GammaMin=ipm_opts.GammaMin,
                PRegMin=ipm_opts.PRegMin,
                DRegMin=ipm_opts.DRegMin,
                OutputLevel=max(params.OutputLevel, ipm_opts.OutputLevel),
            )
            t_ = time.time()
            with profile_ctx:
                state = mpc_solve(dat, backend, opts)
            self.timings["ipm"] = time.time() - t_
        else:
            raise ValueError(f"Unknown IPM algorithm {params.IPM.Algorithm!r}")
        return state


def _trivial_solve(pb_):
    """Closed-form solve for no-variable / no-constraint problems."""
    ncon, nvar = pb_.ncon, pb_.nvar
    sol = Solution(ncon, nvar)
    if nvar == 0:
        lcon = np.asarray(pb_.lcon, dtype=float)
        ucon = np.asarray(pb_.ucon, dtype=float)
        bad_lo = np.isfinite(lcon) & (lcon > 0.0)
        bad_hi = np.isfinite(ucon) & (ucon < 0.0)
        if bad_lo.any() or bad_hi.any():
            i = int(np.flatnonzero(bad_lo | bad_hi)[0])
            sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
            sol.is_dual_ray = True
            if bad_lo[i]:
                sol.y_lower[i] = 1.0
            else:
                sol.y_upper[i] = 1.0
            sol.z_primal = sol.z_dual = np.inf
            return sol, TerminationStatus.PRIMAL_INFEASIBLE
        sol.primal_status = SolutionStatus.OPTIMAL
        sol.dual_status = SolutionStatus.OPTIMAL
        sol.z_primal = sol.z_dual = pb_.obj0
        return sol, TerminationStatus.OPTIMAL

    # ncon == 0: bounds-only LP (internal min-sense duals, like the IPM).
    sense = 1.0 if pb_.objsense else -1.0
    c = sense * np.asarray(pb_.obj, dtype=float)
    lvar = np.asarray(pb_.lvar, dtype=float)
    uvar = np.asarray(pb_.uvar, dtype=float)
    unb = ((c > 0) & ~np.isfinite(lvar)) | ((c < 0) & ~np.isfinite(uvar))
    if unb.any():
        j = int(np.flatnonzero(unb)[0])
        sol.primal_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_primal_ray = True
        sol.x[j] = 1.0 if c[j] < 0 else -1.0
        sol.z_primal = sol.z_dual = -np.inf
        return sol, TerminationStatus.DUAL_INFEASIBLE
    if bool(np.any(lvar > uvar)):
        j = int(np.flatnonzero(lvar > uvar)[0])
        sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_dual_ray = True
        sol.s_lower[j] = 1.0
        sol.s_upper[j] = 1.0
        sol.z_primal = sol.z_dual = np.inf
        return sol, TerminationStatus.PRIMAL_INFEASIBLE
    sol.x[:] = np.where(c > 0, lvar,
                        np.where(c < 0, uvar, np.clip(0.0, lvar, uvar)))
    sol.s_lower[:] = np.maximum(c, 0.0)
    sol.s_upper[:] = np.maximum(-c, 0.0)
    sol.primal_status = SolutionStatus.OPTIMAL
    sol.dual_status = SolutionStatus.OPTIMAL
    z = float(c @ sol.x)
    sol.z_primal = sol.z_dual = z + pb_.obj0 * sense
    return sol, TerminationStatus.OPTIMAL


def _is_oom(e: Exception) -> bool:
    """Device/host memory exhaustion, in its XLA spellings."""
    if isinstance(e, MemoryError):
        return True
    msg = str(e).upper()
    return "RESOURCE_EXHAUSTED" in msg or "OUT OF MEMORY" in msg


def _probe_structure(A_np: np.ndarray) -> Optional[str]:
    """Pick a structure-exploiting backend for a large problem, or None
    for the dense default.

    Order (cheapest signal first): dense columns → tiled sparse Cholesky
    + SMW splitting (a dense column fills K1 = AΘAᵀ completely; the
    role the reference covers by defaulting to CHOLMOD-on-K2,
    reference: src/KKT/KKT.jl:134-141); else banded when RCM finds a
    narrow band (pure staircases); else tiled-sparse K1 when the filled
    tile pattern is sparse (cyclic/corner coupling). All three backends
    re-fall-back internally."""
    from .kkt.sparse import tile_plan
    from .kkt.sparse_ldl import dense_threshold

    m, n = A_np.shape
    colnnz = (np.abs(A_np) > 0).sum(axis=0)

    # Density early-out FIRST: a matrix this dense cannot band or tile
    # whatever its dense-column count (the planners' gates would reject
    # it after much more host work), and routing it to a K2 backend
    # would end at dense-ldl on the (n+m)-sized augmented system —
    # strictly worse than dense K1.
    if int(colnnz.sum()) > 0.2 * m * n:
        return None

    dense_cols = colnnz >= dense_threshold(m)
    if bool(np.any(dense_cols)):
        k = int(dense_cols.sum())
        if k > max(64, 0.02 * n):
            # Too many "dense" columns to be structure + exceptions
            # (the SMW backend's own cap): dense K1.
            return None
        As = A_np.copy()
        As[:, np.flatnonzero(dense_cols)] = 0.0
        if tile_plan(As, 128) is None:
            return None  # dense cols and no residual sparsity: dense K1
        # Measured smw-vs-sparse-ldl routing (round 4; m=2048 staircase +
        # k dense columns, HSD f64 @1e-8, presolve scaling on, 2 sweeps
        # both): smw matches ldl's iteration counts at k <= 8 with
        # moderate column norms (15-18 iters) but STALLS at
        # ITERATION_LIMIT at k = 24 (any norms) and at k = 8 when the
        # dense columns' norms dominate (post-scaling norm ratio ~60) —
        # the rank-k SMW correction loses the forward accuracy that two
        # refinement sweeps can recover. The direct K2 factorization
        # (kappa(K2) = sqrt(kappa(K1))) solved every case in 15-18
        # iterations. Route by dense-column count and the measured
        # norm-dominance signal; prefer smw inside its validated regime.
        cnorm = np.linalg.norm(A_np, axis=0)
        sparse_norms = cnorm[~dense_cols]
        med = float(np.median(sparse_norms)) if sparse_norms.size else 1.0
        ratio = float(cnorm[dense_cols].max() / max(med, 1e-300))
        if k > 8 or (k >= 4 and ratio > 30.0):
            return "sparse-ldl"
        return "sparse-smw"

    from .kkt.banded import rcm_bandwidth

    _, bw = rcm_bandwidth(A_np)
    bw_block = max(128, -(-max(bw, 1) // 128) * 128)
    if 2 * bw_block <= m // 4:
        return "banded"
    if tile_plan(A_np, 128) is not None:
        return "sparse"
    return None


def _certificate_tol(params, dtype=None) -> float:
    """Validation gate scaled from the solve's resolved tolerances
    (round-4 review: a hard-coded 1e-5 gated an f32 @3e-4 run and an
    extended @1e-12 run identically). The IPM certifies rays at
    ~ToleranceIFeas in scaled norms; a 100x margin absorbs the
    postsolve/unscaling amplification, floored at 1e3·eps(dtype)."""
    import numpy as np
    dtype = np.dtype(dtype or params.ArithmeticDtype)
    ifeas = params.IPM.resolved(dtype).ToleranceIFeas
    return max(100.0 * float(ifeas), 1e3 * float(np.finfo(dtype).eps))


def _validate_certificates(pb: ProblemData, sol: Solution,
                           tol: float = 1e-5) -> None:
    """Drop ray claims that do not verify in the original space.

    Termination statuses stay as decided (they are certified by the dual
    reasoning that produced them); but a claimed certificate VECTOR must
    satisfy its defining inequalities, which presolve reductions cannot
    always reconstruct (e.g. a dominated-column dual-infeasibility
    conclusion on a both-primal-and-dual-infeasible LP has no primal ray
    at all). The reference reports such junk rays as certificates
    (reference: dominated_column.jl:46); we report UNKNOWN instead.
    """
    if not (sol.is_primal_ray or sol.is_dual_ray):
        return
    # Vectorized over the COO export: flat per-solve host cost at any
    # problem size (the bincount pattern of _extract_solution).
    I, J, V = pb.to_coo()
    lcon = np.asarray(pb.lcon, dtype=float)
    ucon = np.asarray(pb.ucon, dtype=float)
    lvar = np.asarray(pb.lvar, dtype=float)
    uvar = np.asarray(pb.uvar, dtype=float)

    if sol.is_primal_ray:
        d = sol.x
        nrm = max(1.0, float(np.max(np.abs(d))) if len(d) else 1.0)
        ad = (np.bincount(I, V * d[J], minlength=pb.ncon)
              if len(I) else np.zeros(pb.ncon))
        ok = not (bool(np.any(np.isfinite(lcon) & (ad < -tol * nrm)))
                  or bool(np.any(np.isfinite(ucon) & (ad > tol * nrm)))
                  or bool(np.any(np.isfinite(lvar) & (d < -tol * nrm)))
                  or bool(np.any(np.isfinite(uvar) & (d > tol * nrm))))
        sense = 1.0 if pb.objsense else -1.0
        if sense * float(np.dot(np.asarray(pb.obj), d)) >= -tol * nrm:
            ok = False
        if not ok:
            sol.is_primal_ray = False
            sol.primal_status = SolutionStatus.UNKNOWN

    if sol.is_dual_ray:
        y = sol.y_lower - sol.y_upper
        s = sol.s_lower - sol.s_upper
        nrm = max(1.0,
                  float(np.max(np.abs(y))) if len(y) else 1.0,
                  float(np.max(np.abs(s))) if len(s) else 1.0)
        resid = s + (np.bincount(J, V * y[I], minlength=pb.nvar)
                     if len(I) else 0.0)
        ok = bool(np.max(np.abs(resid)) <= tol * nrm) if len(resid) else True
        if (bool(np.any((sol.y_lower > tol * nrm) & ~np.isfinite(lcon)))
                or bool(np.any((sol.y_upper > tol * nrm)
                               & ~np.isfinite(ucon)))
                or bool(np.any((sol.s_lower > tol * nrm)
                               & ~np.isfinite(lvar)))
                or bool(np.any((sol.s_upper > tol * nrm)
                               & ~np.isfinite(uvar)))):
            ok = False
        val = (float(sol.y_lower @ np.where(np.isfinite(lcon), lcon, 0.0))
               - float(sol.y_upper @ np.where(np.isfinite(ucon), ucon, 0.0))
               + float(sol.s_lower @ np.where(np.isfinite(lvar), lvar, 0.0))
               - float(sol.s_upper @ np.where(np.isfinite(uvar), uvar, 0.0)))
        if val <= tol * nrm:
            ok = False
        if not ok:
            sol.is_dual_ray = False
            sol.dual_status = SolutionStatus.UNKNOWN


def _extract_solution(sol: Solution, pb: ProblemData, state,
                      n_struct: int) -> None:
    """Map the standard-form iterate back to the general-form problem
    (reference: src/model.jl:156-215): drop slack columns, divide by τ
    unless the point is a certificate ray, sign-split row duals."""
    pt = state.pt
    n = n_struct

    sol.primal_status = SolutionStatus(int(state.primal_status))
    sol.dual_status = SolutionStatus(int(state.dual_status))
    is_primal_ray = sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    is_dual_ray = sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE
    sol.is_primal_ray = is_primal_ray
    sol.is_dual_ray = is_dual_ray
    tau_inv = 1.0 if (is_primal_ray or is_dual_ray) else 1.0 / float(pt.tau)

    x = np.asarray(pt.x)
    zl = np.asarray(pt.zl)
    zu = np.asarray(pt.zu)
    y = np.asarray(pt.y)

    sol.x[:] = x[:n] * tau_inv
    sol.s_lower[:] = zl[:n] * tau_inv
    sol.s_upper[:] = zu[:n] * tau_inv
    sol.y_lower[:] = np.maximum(y, 0.0) * tau_inv
    sol.y_upper[:] = np.maximum(-y, 0.0) * tau_inv

    # Row activity in original space (COO bincount: works for both
    # ProblemData and the vectorized ReducedArrays container).
    I, J, V = pb.to_coo()
    if len(I):
        sol.Ax[:] = np.bincount(I, V * np.asarray(sol.x)[J],
                                minlength=pb.ncon)
    else:
        sol.Ax[:] = 0.0

    pobj = float(state.pobj)
    dobj = float(state.dobj)
    if sol.primal_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = -np.inf
        sol.z_dual = -np.inf
    elif sol.primal_status in (SolutionStatus.OPTIMAL,
                               SolutionStatus.FEASIBLE_POINT):
        sol.z_primal = pobj
    else:
        sol.z_primal = np.nan

    if sol.dual_status == SolutionStatus.INFEASIBILITY_CERTIFICATE:
        sol.z_primal = np.inf
        sol.z_dual = np.inf
    elif sol.dual_status in (SolutionStatus.OPTIMAL,
                             SolutionStatus.FEASIBLE_POINT):
        sol.z_dual = dobj
    else:
        sol.z_dual = np.nan

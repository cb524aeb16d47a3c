"""Command-line interface.

Mirrors the reference CLI (reference: app/src/TulipCL.jl:20-91)::

    python -m tulip_tpu.cli [--TimeLimit T] [--IterationsLimit N]
                            [--Presolve L] [--Method HSD|MPC] file.mps
"""

from __future__ import annotations

import argparse
import sys

from . import Model, load_problem, set_parameter
from .status import TerminationStatus
from .utils import enable_compile_cache


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """Parse ``argv``, load and solve the instance: ``(exit code, Model)``
    (the Model is None when the file does not exist)."""
    enable_compile_cache()
    p = argparse.ArgumentParser(
        prog="tulip_tpu",
        description="Interior-point LP solver in JAX")
    p.add_argument("finst", help="MPS instance file (.mps, .mps.gz, .mps.bz2)")
    p.add_argument("--TimeLimit", type=float, default=float("inf"))
    p.add_argument("--IterationsLimit", type=int, default=100)
    p.add_argument("--Threads", type=int, default=1,
                   help="accepted for reference-CLI parity; XLA manages "
                        "device parallelism")
    p.add_argument("--Presolve", type=int, default=1)
    p.add_argument("--Method", choices=["HSD", "MPC"], default="HSD")
    p.add_argument("--KKTBackend", default=None)
    p.add_argument("--SparseFirst", type=int, choices=[0, 1], default=None,
                   help="force (1) / disable (0) the sparse-first data "
                        "path; default: auto above KKT_SparseFirstThreshold")
    p.add_argument("--Dtype", default="float64")
    p.add_argument("--OutputLevel", type=int, default=1)
    args = p.parse_args(argv)

    m = Model()
    try:
        load_problem(m, args.finst)
    except FileNotFoundError:
        print(f"tulip_tpu: error: no such file: {args.finst}",
              file=sys.stderr)
        return 2, None
    m.params.OutputLevel = args.OutputLevel
    m.params.ArithmeticDtype = args.Dtype
    m.params.Threads = args.Threads
    set_parameter(m, "IPM_TimeLimit", args.TimeLimit)
    set_parameter(m, "IPM_IterationsLimit", args.IterationsLimit)
    set_parameter(m, "Presolve_Level", args.Presolve)
    set_parameter(m, "IPM_Algorithm", args.Method)
    if args.KKTBackend:
        set_parameter(m, "KKT_Backend", args.KKTBackend)
    if args.SparseFirst is not None:
        set_parameter(m, "KKT_SparseFirst", bool(args.SparseFirst))

    st = m.optimize()
    if args.OutputLevel > 0:
        from . import get_attribute
        try:
            z = get_attribute(m, "ObjectiveValue")
            print(f"result: {st.name} objective {z!r} "
                  f"time {m.solve_time:.3f}s")
        except Exception:
            print(f"result: {st.name} time {m.solve_time:.3f}s")
    return (0 if st == TerminationStatus.OPTIMAL else 1), m


if __name__ == "__main__":
    sys.exit(main())

"""Golden-run harness: solve a set of LP instances and record
objective / iterations / wall-clock per configuration.

Usage:
    python benchmarks/harness.py [--dir DIR] [--algo HSD|MPC]
                                 [--dtype float64] [--out results.json]

With --dir, every ``*.mps[.gz|.bz2]`` file in DIR is solved (drop a Netlib
mirror there to run the real set — not vendored here: zero-egress build).
Without it, the synthetic golden families from tests/golden_lps.py run,
each validated against scipy HiGHS.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None)
    ap.add_argument("--algo", default="HSD", choices=["HSD", "MPC"])
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU platform")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import tulip_tpu as tlp
    from tulip_tpu.status import TerminationStatus
    from tulip_tpu.utils import enable_compile_cache

    enable_compile_cache()

    records = []

    def solve(pb, name, z_ref=None):
        m = tlp.Model()
        m.pbdata = pb
        m.params.IPM.Algorithm = args.algo
        m.params.ArithmeticDtype = args.dtype
        t0 = time.time()
        st = m.optimize()
        wall = time.time() - t0
        rec = {
            "instance": name,
            "rows": pb.ncon, "cols": pb.nvar, "nnz": pb.nnz,
            "status": st.name,
            "objective": (tlp.get_attribute(m, "ObjectiveValue")
                          if st == TerminationStatus.OPTIMAL else None),
            "iterations": m.barrier_iterations,
            "time_s": round(wall, 4),
        }
        if z_ref is not None and rec["objective"] is not None:
            rec["ref_objective"] = z_ref
            rec["rel_err"] = abs(rec["objective"] - z_ref) / max(1, abs(z_ref))
        records.append(rec)
        print(json.dumps(rec))

    if args.dir:
        files = sorted(sum((glob.glob(os.path.join(args.dir, p))
                            for p in ("*.mps", "*.mps.gz", "*.mps.bz2",
                                      "*.SIF")), []))
        if not files:
            print(f"no instances in {args.dir}", file=sys.stderr)
            return 1
        for f in files:
            m = tlp.Model()
            tlp.load_problem(m, f)
            solve(m.pbdata, os.path.basename(f))
    else:
        from golden_lps import ALL_GOLDEN, scipy_optimum
        for gen in ALL_GOLDEN:
            pb = gen()
            solve(pb, pb.name, scipy_optimum(pb))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    n_opt = sum(r["status"] == "OPTIMAL" for r in records)
    print(f"\n{n_opt}/{len(records)} optimal; "
          f"total {sum(r['time_s'] for r in records):.2f}s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

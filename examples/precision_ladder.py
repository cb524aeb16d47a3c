"""One LP solved across the arithmetic ladder (the role of the reference's
examples/optimal_other_type.jl, which solves in Float32; the reference's
test suite additionally runs BigFloat).

The device has no arbitrary-precision unit, so the ladder here is:

    float32            ~1e-4 tolerances
    mixed              f32 factorize + f64 refine, 1e-8
    float64            1e-8 (the reference's default regime)
    extended           f64 factorize + double-double refine, 1e-12

    min  -2x - y   s.t.  x - y >= -2,  2x - y <= 4,  x + 2y <= 7,  x,y >= 0
    ->   z* = -8 at (3, 2)   (the reference example's LP)
"""

import numpy as np

import tulip_tpu as tlp

INF = float("inf")

LADDER = [
    ("float32", "dense", 1e-4),
    ("float64", "dense-mixed", 1e-8),
    ("float64", "dense", 1e-8),
    ("float64", "extended", 1e-12),
]


def build(m):
    pb = m.pbdata
    x = pb.add_variable((), (), -2.0, 0.0, INF, "x")
    y = pb.add_variable((), (), -1.0, 0.0, INF, "y")
    pb.add_constraint([x, y], [1.0, -1.0], -2.0, INF, "r1")
    pb.add_constraint([x, y], [2.0, -1.0], -INF, 4.0, "r2")
    pb.add_constraint([x, y], [1.0, 2.0], -INF, 7.0, "r3")


def main():
    for dtype, backend, tol in LADDER:
        m = tlp.Model()
        m.params.OutputLevel = 0
        m.params.ArithmeticDtype = dtype
        m.params.KKT.Backend = backend
        for t in ("PFeas", "DFeas", "RGap", "IFeas"):
            tlp.set_parameter(m, f"IPM_Tolerance{t}", tol)
        build(m)
        st = m.optimize()
        assert st == tlp.TerminationStatus.OPTIMAL, (dtype, backend, st)
        z = tlp.get_attribute(m, "ObjectiveValue")
        zd = tlp.get_attribute(m, "DualObjectiveValue")
        print(f"{dtype:8s} + {backend:12s} tol={tol:.0e}  "
              f"z={z:.12f}  gap={abs(z - zd):.2e}  x={np.round(m.solution.x, 6)}")
        assert abs(z - (-8.0)) < 100 * tol
        assert abs(m.solution.x[0] - 3.0) < 1000 * tol


if __name__ == "__main__":
    main()

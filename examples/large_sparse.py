"""Arbitrary-scale sparse LP through the sparse-first data path.

Builds an m=16384 multiperiod staircase (2.1 M nonzeros) and solves it
to the reference-default 1.49e-8 tolerances WITHOUT ever materializing
the dense (m, n) constraint matrix: the standard form is assembled
straight from COO into support-compressed tiles
(tulip_tpu/ipm/sparse_data.py), the symbolic plan is O(nnz), and the
level-scheduled tile Cholesky factorizes on device. Dense A for this
instance would be ~3.2 GB; the compressed arrays are ~200 MB.

This is the capability the reference delegates to CHOLMOD-on-CSC
(reference: src/KKT/Cholmod/sqd.jl:42-53) — run `python
examples/large_sparse.py [m]` (CPU works; a GPU solves it faster after
the one-time compile).
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import scipy.sparse as sp

import tulip_tpu as tlp


def staircase(m, mr=64, nc=96, seed=0):
    rng = np.random.default_rng(seed)
    stages = m // mr
    n = stages * nc + nc
    I, J, V = [], [], []
    for s in range(stages):
        for c0 in (s * nc, (s + 1) * nc):
            ii, jj = np.meshgrid(np.arange(s * mr, (s + 1) * mr),
                                 np.arange(c0, c0 + nc), indexing="ij")
            I.append(ii.ravel())
            J.append(jj.ravel())
            V.append(rng.standard_normal(mr * nc))
    I, J, V = map(np.concatenate, (I, J, V))
    A = sp.csr_matrix((V, (I, J)), shape=(m, n))
    u = rng.uniform(1, 3, n)
    x0 = u * rng.uniform(0.3, 0.7, n)
    return A, np.asarray(A @ x0), rng.standard_normal(n), u


def main():
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    A, b, c, u = staircase(m)
    n = A.shape[1]
    print(f"instance: {m} rows x {n} cols, {A.nnz} nonzeros "
          f"(dense A would be {m * n * 8 / 1e9:.1f} GB)")

    mod = tlp.Model()
    coo = A.tocoo()
    mod.pbdata.load(True, c, 0.0, (coo.row, coo.col, coo.data),
                    b, b, np.zeros(n), u, name=f"stair{m}")
    mod.params.KKT.SparseFirst = True     # auto above m >= 8192 anyway
    mod.params.OutputLevel = 1

    t0 = time.time()
    st = mod.optimize()
    print(f"\nstatus {st.name} in {mod.barrier_iterations} iterations, "
          f"{time.time() - t0:.1f}s "
          f"(backend {mod.kkt_backend.name}; timings {mod.timings})")
    print("objective", tlp.get_attribute(mod, "ObjectiveValue"))


if __name__ == "__main__":
    main()

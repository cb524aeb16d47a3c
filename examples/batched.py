"""Scenario-batched solving: many LPs in one vmapped solve.

No reference analogue — this is the batched scaling axis (SURVEY §2.6).
"""

import numpy as np

import tulip_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from tulip_tpu.ipm.batch import batched_hsd_solve, stack_lps
from tulip_tpu.ipm.data import make_lp_data
from tulip_tpu.ipm.hsd import HSDOptions
from tulip_tpu.kkt import DenseK1Backend


def main():
    rng = np.random.default_rng(0)
    lps = []
    for _ in range(32):
        A = rng.standard_normal((6, 12))
        u = rng.uniform(1, 4, 12)
        x0 = u * rng.uniform(0.2, 0.8, 12)
        lps.append(make_lp_data(A, A @ x0, rng.standard_normal(12), 0.0,
                                np.zeros(12), u, dtype=jnp.float64))

    out = batched_hsd_solve(DenseK1Backend(), HSDOptions(), stack_lps(lps))
    st = np.asarray(out.status)
    print(f"optimal: {(st == 2).sum()}/32, "
          f"mean iterations {np.asarray(out.niter).mean():.1f}")
    print("objectives:", np.round(np.asarray(out.pobj), 4))

    # High-level equivalent: one call, heterogeneous shapes allowed.
    probs = []
    for k in range(4):
        n = 8 + 2 * k                      # mixed sizes in one batch
        A = rng.standard_normal((4, n))
        u = rng.uniform(1, 4, n)
        x0 = u * rng.uniform(0.2, 0.8, n)
        probs.append(dict(c=rng.standard_normal(n), A_eq=A, b_eq=A @ x0,
                          bounds=list(zip(np.zeros(n), u))))
    import tulip_tpu as tlp
    res = tlp.batch_linprog(probs, dtype="float64")
    print("batch_linprog:", [round(r.fun, 4) for r in res])


if __name__ == "__main__":
    main()

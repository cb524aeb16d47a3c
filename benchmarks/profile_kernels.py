"""Profile the per-iteration kernel components on the current accelerator:
batched Gram assembly (A D Aᵀ), batched Cholesky, batched triangular
solves — the entire per-iteration cost profile of the IPM (reference
profile: src/IPM/HSD/step.jl:37,63,79,93). Guides which ops deserve
custom kernels vs XLA defaults.

Timing methodology: each op is iterated inside an on-device
``lax.fori_loop`` with a data dependence chaining iterations, so one host
dispatch covers ``reps`` executions and dispatch latency drops out.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def device_loop_time(op, init_carry, reps=50):
    """Wall time per op execution, measured via an on-device fori_loop.

    ``op(carry) -> carry`` must be shape-stable and data-dependent on its
    input (prevents hoisting/DCE).
    """
    @jax.jit
    def run(carry):
        return jax.lax.fori_loop(0, reps, lambda i, c: op(c), carry)

    out = jax.block_until_ready(run(init_carry))   # compile + warm
    t0 = time.time()
    out = jax.block_until_ready(run(init_carry))
    np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
    return (time.time() - t0) / reps, out


def profile(B, m, n, dtype=jnp.float32, reps=50):
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((B, m, n)), dtype)
    d0 = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)), dtype)
    reg = jnp.asarray(np.full((B, m), 1e-3), dtype)
    rhs0 = jnp.asarray(rng.standard_normal((B, m)), dtype)

    with jax.default_matmul_precision("highest"):
        def gram(d):
            Bm = A * jnp.sqrt(d)[:, None, :]
            K = jnp.einsum("bij,bkj->bik", Bm, Bm)
            return K + jax.vmap(jnp.diag)(reg)

        K0 = jax.jit(gram)(d0)
        L0 = jnp.linalg.cholesky(K0)

        def gram_op(d):
            K = gram(d)
            # chain: perturb d by a value derived from K
            return d * (1.0 + 1e-30 * K[:, 0, 0:1])

        def chol_op(K):
            L = jnp.linalg.cholesky(K)
            return K * (1.0 + 1e-30 * L[:, 0, 0:1, None])

        def tri_op(r):
            w = jax.scipy.linalg.solve_triangular(
                L0, r[..., None], lower=True)
            s = jax.scipy.linalg.solve_triangular(
                jnp.swapaxes(L0, -1, -2), w, lower=False)[..., 0]
            return r + 1e-30 * s

        def mv_op(r):
            v = jnp.einsum("bij,bi->bj", A, r)        # A'r
            w = jnp.einsum("bij,bj->bi", A, v)        # A(A'r)
            return r + 1e-30 * w

        t_gram, _ = device_loop_time(gram_op, d0, reps)
        t_chol, _ = device_loop_time(chol_op, K0, reps)
        t_tri, _ = device_loop_time(tri_op, rhs0, reps)
        t_mv, _ = device_loop_time(mv_op, rhs0, reps)

    gram_fl = 2 * B * m * m * n
    chol_fl = B * m ** 3 / 3
    tri_fl = 2 * B * m * m
    mv_fl = 4 * B * m * n
    print(f"B={B:5d} m={m:5d} n={n:5d} {jnp.dtype(dtype).name}")
    print(f"  gram       {t_gram*1e3:9.3f} ms  {gram_fl/t_gram/1e12:8.3f} TFLOP/s")
    print(f"  cholesky   {t_chol*1e3:9.3f} ms  {chol_fl/t_chol/1e12:8.3f} TFLOP/s")
    print(f"  trisolve2  {t_tri*1e3:9.3f} ms  {tri_fl/t_tri/1e12:8.3f} TFLOP/s")
    print(f"  matvec2    {t_mv*1e3:9.3f} ms  {mv_fl/t_mv/1e12:8.3f} TFLOP/s")
    sys.stdout.flush()
    return dict(gram=t_gram, chol=t_chol, tri=t_tri, mv=t_mv)


if __name__ == "__main__":
    sys.path.insert(0, ".")
    from tulip_tpu.utils import enable_compile_cache

    enable_compile_cache()
    print("platform:", jax.devices()[0].platform, jax.devices()[0])
    profile(1024, 48, 96)
    profile(1024, 64, 128)
    profile(256, 128, 256)
    profile(1, 1024, 2048, reps=20)
    profile(1, 2048, 4096, reps=10)
    profile(8, 512, 1024, reps=20)

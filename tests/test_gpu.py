"""Card-only tests: the dense K1 backend's update and solve on the GPU
against numpy, and the f32 matmul precision the IPM pins there.

They skip without a GPU. Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -o addopts=``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tulip_tpu.kkt import DenseK1Backend

pytestmark = pytest.mark.gpu

M, N = 4096, 8192


def _system(seed=0):
    """A normal-equations system of moderate condition: Gaussian A,
    Θ⁻¹ in [0.5, 2], regularizations 1e-3."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    theta_inv = rng.uniform(0.5, 2.0, N)
    regP, regD = np.full(N, 1e-3), np.full(M, 1e-3)
    xi_p, xi_d = rng.standard_normal(M), rng.standard_normal(N)
    return A, theta_inv, regP, regD, xi_p, xi_d


def _reference(A, theta_inv, regP, regD, xi_p, xi_d):
    """dy, dx of the K1 system by numpy in float64."""
    d = 1.0 / (theta_inv + regP)
    K = (A * d) @ A.T + np.diag(regD)
    dy = np.linalg.solve(K, xi_p + A @ (d * xi_d))
    dx = d * (A.T @ dy - xi_d)
    return dy, dx


def _device_solve(dtype, A, theta_inv, regP, regD, xi_p, xi_d):
    be = DenseK1Backend()
    args = [jnp.asarray(v, dtype) for v in (theta_inv, regP, regD)]
    rhs = [jnp.asarray(v, dtype) for v in (xi_p, xi_d)]

    @jax.jit
    def run(A):
        st, ok = be.update(be.setup(A), *args)
        dx, dy = be.solve(st, *rhs)
        return ok, dx, dy

    ok, dx, dy = run(jnp.asarray(A, dtype))
    assert bool(ok)
    return np.asarray(dy, np.float64), np.asarray(dx, np.float64)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def system():
    sysm = _system()
    return sysm, _reference(*sysm)


def test_dense_k1_f64_matches_numpy(gpu_device, system):
    sysm, (dy_ref, dx_ref) = system
    dy, dx = _device_solve(jnp.float64, *sysm)
    assert _rel(dy, dy_ref) <= 1e-10
    assert _rel(dx, dx_ref) <= 1e-10


def test_dense_k1_f32_highest_matches_numpy(gpu_device, system):
    sysm, (dy_ref, dx_ref) = system
    with jax.default_matmul_precision("highest"):
        dy, dx = _device_solve(jnp.float32, *sysm)
    assert _rel(dy, dy_ref) <= 1e-4
    assert _rel(dx, dx_ref) <= 1e-4


def test_default_f32_precision_is_coarser(gpu_device, system):
    """At default precision f32 matmuls on the card run in TF32: the same
    solve lands well outside the "highest" bound, which is why the IPM
    pins "highest"."""
    sysm, (dy_ref, _) = system
    with jax.default_matmul_precision("highest"):
        dy_hi, _ = _device_solve(jnp.float32, *sysm)
    dy_def, _ = _device_solve(jnp.float32, *sysm)
    assert _rel(dy_def, dy_ref) > 1e-4
    assert _rel(dy_def, dy_ref) > 10 * _rel(dy_hi, dy_ref)

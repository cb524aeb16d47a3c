"""Generic KKT backend conformance test kit.

Shipped inside the package (not under tests/) so third-party backends can
self-verify against the augmented-system contract, mirroring the
reference's ``KKT.run_ls_tests`` (reference: src/KKT/Test/test.jl:9-47)
— and going beyond it: the reference kit tests exactly one benign
θ = reg = 1 configuration, which predicts nothing about late-IPM
viability (round-4 finding: sparse-ldl's ND schedule and SMW's forward
error both broke end-to-end while passing the benign kit). This kit adds
**ill-conditioning sweeps** — θ⁻¹ uniform at 1e8 and spanning 16 decades
per-column, regularizations at the IPM's √eps floors — and checks the
scale-aware relative residual after the backend's own refinement.

Measured sweep behavior (64×96 Gaussian A, f64, round 5): direct
backends hold ≤ 3e-7 relative on the 16-decade sweep (extended/
extended-dd: ~4e-16); matrix-free Krylov backends satisfy weighted/
preconditioned criteria instead and sit at 1e-2..1e0 — they opt out via
``sweep_resid_atol = None`` and are validated end-to-end at their
measured achievable tolerances (tests/test_krylov_golden.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _augmented_rel_resid(A, backend, state, theta_inv, regP, regD, rng):
    """Solve with random RHS; return the scale-aware relative residual
    max over the two augmented-system rows."""
    m, n = A.shape
    xi_p = jnp.asarray(rng.standard_normal(m), dtype=A.dtype)
    xi_d = jnp.asarray(rng.standard_normal(n), dtype=A.dtype)
    dx, dy = backend.solve(state, xi_p, xi_d)
    rd = xi_d - (-(theta_inv + regP) * dx + A.T @ dy)
    rp = xi_p - (A @ dx + regD * dy)
    scale_d = float(jnp.max(jnp.abs(xi_d))
                    + jnp.max(jnp.abs((theta_inv + regP) * dx))
                    + jnp.max(jnp.abs(A.T @ dy)))
    scale_p = float(jnp.max(jnp.abs(xi_p)) + jnp.max(jnp.abs(A @ dx))
                    + jnp.max(jnp.abs(regD * dy)))
    return max(float(jnp.max(jnp.abs(rd))) / max(scale_d, 1.0),
               float(jnp.max(jnp.abs(rp))) / max(scale_p, 1.0))


def run_ls_tests(A, backend, atol: float = None, sweep: bool = True,
                 sweep_atol: float = None, seed: int = 0,
                 strict_sweep: bool = False) -> None:
    """Assert that ``backend`` satisfies the setup/update/solve contract on
    matrix ``A``.

    1. Benign configuration (reference parity, test.jl:9-47): unit θ⁻¹
       and regularizations, unit RHS, absolute residuals ≤ ``atol``.
    2. Late-IPM sweeps (beyond reference): θ⁻¹ ∈ {uniform 1e8,
       log-spread over 16 decades}, regularizations at √eps floors,
       random RHS; scale-aware RELATIVE residual ≤ the sweep gate.
       The gate is ``sweep_atol`` if given, else the backend's
       ``sweep_resid_atol`` class attribute (1e-6 for direct methods;
       ``None`` opts out — matrix-free backends). Sweeps run only in
       f64 (the f32 paths reach √eps(f32) at best, and mixed-precision
       backends legitimately report factorization failure at 16-decade
       spreads — the IPM's reg-bump ladder is the contract there).
       An ``update`` returning ok=False inside a sweep is accepted: the
       backend honestly reported failure instead of returning garbage.
    """
    A = jnp.asarray(A)
    m, n = A.shape
    dt = A.dtype
    if atol is None:
        atol = float(np.sqrt(np.finfo(np.dtype(dt.name)).eps)) * 10

    state = backend.setup(A)

    theta_inv = jnp.ones(n, dtype=dt)
    regP = jnp.ones(n, dtype=dt)
    regD = jnp.ones(m, dtype=dt)
    state, ok = backend.update(state, theta_inv, regP, regD)
    assert bool(ok), f"{backend.name}: update failed on a benign system"

    xi_p = jnp.ones(m, dtype=dt)
    xi_d = jnp.ones(n, dtype=dt)
    dx, dy = backend.solve(state, xi_p, xi_d)

    # Augmented-system residuals (reference: test.jl:33-44):
    #   rd = ξd + (Θ⁻¹+Rp) dx - Aᵀ dy ;  rp = ξp - A dx - Rd dy
    rd = xi_d - (-(theta_inv + regP) * dx + A.T @ dy)
    rp = xi_p - (A @ dx + regD * dy)
    rd_nrm = float(jnp.max(jnp.abs(rd)))
    rp_nrm = float(jnp.max(jnp.abs(rp)))
    assert rd_nrm <= atol, (
        f"{backend.name}: dual residual {rd_nrm:.3e} > {atol:.3e}")
    assert rp_nrm <= atol, (
        f"{backend.name}: primal residual {rp_nrm:.3e} > {atol:.3e}")

    # ---- late-IPM ill-conditioning sweeps ------------------------------
    gate = sweep_atol if sweep_atol is not None else getattr(
        backend, "sweep_resid_atol", 1e-6)
    if not sweep or gate is None or dt != jnp.float64:
        return
    rng = np.random.default_rng(seed)
    se = float(np.sqrt(np.finfo(np.float64).eps))
    regP_f = jnp.full(n, se, dtype=dt)
    regD_f = jnp.full(m, se, dtype=dt)
    sweeps = [
        ("theta-uniform-1e8", jnp.full(n, 1e8, dtype=dt)),
        ("theta-mixed-16-decades",
         jnp.asarray(10.0 ** rng.uniform(-8, 8, n), dtype=dt)),
    ]
    for label, ti in sweeps:
        st, ok = backend.update(state, ti, regP_f, regD_f)
        if not bool(ok):
            # Honest failure → IPM reg-bump territory, accepted by
            # default. ``strict_sweep`` is for backends claiming
            # direct-method robustness: there a factorization failure at
            # √eps regularization floors IS the late-IPM regression
            # (e.g. the K2 level schedule's separator growth, which is
            # why sparse-ldl defaults to the RCM column schedule).
            assert not strict_sweep, (
                f"{backend.name}: update reported failure on the {label} "
                f"sweep at the √eps regularization floors")
            continue
        r = _augmented_rel_resid(A, backend, st, ti, regP_f, regD_f, rng)
        assert r <= gate, (
            f"{backend.name}: relative residual {r:.3e} > {gate:.3e} on "
            f"the {label} sweep — this backend would lose the late-IPM "
            f"accuracy the regularization floors assume")

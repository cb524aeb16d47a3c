"""Sparse-first LPData path: standard form assembled straight from COO
with support-compressed tile storage — the dense (m, n) array is never
materialized (the reference's CHOLMOD-at-any-scale capability,
reference: src/KKT/Cholmod/sqd.jl:42-53, src/problemData.jl:43-44)."""

import numpy as np
import pytest
import scipy.sparse as sp

import tulip_tpu as tlp
from tulip_tpu.ipm.data import matvec, rmatvec, standard_form_arrays
from tulip_tpu.ipm.sparse_data import (sparse_lp_data_from_problem,
                                       sparse_pattern_signals,
                                       standard_form_coo)
from tulip_tpu.status import TerminationStatus

from golden_large import (highs_optimum, load_model, scattered_coupling_lp,
                          staircase_lp)


def _model(m=2048, **kw):
    A, b, c, u = staircase_lp(m, **kw)
    return load_model(A, b, c, u, name=f"sf{m}"), (A, b, c, u)


def test_standard_form_coo_matches_dense():
    """COO standard form == dense standard form on a general-bounds LP
    (all 5 row cases: equality, free, <=, >=, range)."""
    mod = tlp.Model()
    pb = mod.pbdata
    rng = np.random.default_rng(0)
    for j in range(6):
        pb.add_variable(obj=float(rng.standard_normal()),
                        lb=0.0, ub=float(j + 1))
    bounds = [(1.0, 1.0), (-np.inf, np.inf), (-np.inf, 2.0),
              (0.5, np.inf), (-1.0, 3.0)]
    for i, (lb, ub) in enumerate(bounds):
        cols = [j for j in range(6) if (i + j) % 2 == 0]
        pb.add_constraint(cols, [float(rng.standard_normal())
                                 for _ in cols], lb=lb, ub=ub)

    Ad, bd, cd, c0d, ld, ud, sd = standard_form_arrays(pb)
    I, J, V, ntot, bs, cs, c0s, ls, us, ss = standard_form_coo(pb)
    As = sp.csr_matrix((V, (I, J)), shape=(pb.ncon, ntot)).toarray()
    np.testing.assert_allclose(As, Ad)
    np.testing.assert_allclose(bs, bd)
    np.testing.assert_allclose(cs, cd)
    assert c0s == c0d and ss == sd
    np.testing.assert_allclose(ls, ld)
    np.testing.assert_allclose(us, ud)


def test_sparse_lpdata_operators_match_dense():
    """matvec/rmatvec over the compressed blocks == scipy SpMV."""
    mod, _ = _model(2048)
    pb = mod.pbdata
    res = sparse_lp_data_from_problem(pb)
    assert res is not None
    dat, n_struct, _ = res
    assert not hasattr(dat, "A")          # the point of this path

    I, J, V, ntot, b, c, c0, l, u, _ = standard_form_coo(pb)
    A = sp.csr_matrix((V, (I, J)), shape=(pb.ncon, ntot))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(ntot)
    y = rng.standard_normal(pb.ncon)
    np.testing.assert_allclose(np.asarray(matvec(dat, x)), A @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rmatvec(dat, y)), A.T @ y,
                               rtol=1e-12, atol=1e-12)


def test_sparse_first_forced_end_to_end():
    """m=2048 staircase, SparseFirst forced: solves to 1e-8 through
    Model.optimize() on the tile path, objective vs HiGHS."""
    mod, (A, b, c, u) = _model(2048)
    mod.params.KKT.SparseFirst = True
    st = mod.optimize()
    assert st == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "sparse"
    assert mod.kkt_backend.refinement_steps >= 1
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_optimum(A, b, c, u)
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


def test_sparse_first_auto_threshold():
    """Auto routing: beyond SparseFirstThreshold the model takes the
    sparse-first path with no dense probe scan. (Routing-only: the
    iteration cap keeps this cheap; the forced test above proves the
    full solve.)"""
    mod, _ = _model(2048)
    mod.params.KKT.SparseFirstThreshold = 2048
    mod.params.IPM.IterationsLimit = 2
    mod.optimize()
    assert mod.kkt_backend.name == "sparse"
    # The O(mn) dense probe never ran (its cache stays empty).
    assert mod._probe_cache is None


@pytest.mark.slow
def test_sparse_first_dense_column_smw_end_to_end():
    """Dense linking columns WITHIN the measured SMW regime (k <= 8,
    norm ratio <= 30) ride the sparse-first path too: they split out as
    the explicit skinny U at the data level (A = As + U e^T), the tile
    plan covers the sparse part, and the SMW backend solves to 1e-8 —
    still never materializing a dense (m, n) array."""
    mod, (A, b, c, u) = _model(2048, dense_cols=2)
    sig = sparse_pattern_signals(mod.pbdata)
    assert sig["n_dense_cols"] == 2
    mod.params.KKT.SparseFirstThreshold = 2048
    st = mod.optimize()
    assert mod.kkt_backend.name == "sparse-smw"
    # The state's full operator is the SparseLPData, not a dense matrix.
    import jax.numpy as jnp
    from tulip_tpu.ipm.sparse_data import SparseLPData
    assert isinstance(mod.solver_state.kkt.A, SparseLPData)
    assert st == TerminationStatus.OPTIMAL
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_optimum(A, b, c, u)
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


def test_sparse_first_dense_column_smw_routing():
    """Cheap default-tier check of the SMW sparse-first routing (the
    full solve + HiGHS parity runs in the slow tier above)."""
    mod, _ = _model(2048, dense_cols=2)
    mod.params.KKT.SparseFirstThreshold = 2048
    mod.params.IPM.IterationsLimit = 2
    mod.optimize()
    assert mod.kkt_backend.name == "sparse-smw"
    from tulip_tpu.ipm.sparse_data import SparseLPData
    assert isinstance(mod.solver_state.kkt.A, SparseLPData)


def test_sparse_first_many_dense_columns_fall_back():
    """Beyond the SMW regime (k > 8: measured ITERATION_LIMIT stalls)
    auto routing refuses sparse-first and the dense
    probe routes to the direct K2 factorization."""
    mod, _ = _model(2048, dense_cols=24)
    sig = sparse_pattern_signals(mod.pbdata)
    assert sig["n_dense_cols"] == 24
    mod.params.KKT.SparseFirstThreshold = 2048
    mod.params.IPM.IterationsLimit = 2
    mod.optimize()
    assert mod.kkt_backend.name == "sparse-ldl"


@pytest.mark.slow
def test_sparse_first_mpc():
    """The MPC algorithm runs on SparseLPData too (operator dispatch)."""
    mod, (A, b, c, u) = _model(2048)
    mod.params.KKT.SparseFirst = True
    mod.params.IPM.Algorithm = "MPC"
    st = mod.optimize()
    assert st == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "sparse"
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_optimum(A, b, c, u)
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


@pytest.mark.slow
def test_sparse_first_scattered_coupling():
    """Scattered long-range couplings (off-band tiles) through the
    sparse-first path."""
    A, b, c, u = scattered_coupling_lp(2048)
    mod = load_model(A, b, c, u, name="sfscatter")
    mod.params.KKT.SparseFirst = True
    st = mod.optimize()
    assert st == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "sparse"
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_optimum(A, b, c, u)
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))


@pytest.mark.slow
def test_sparse_first_m8192():
    """m=8192 multiperiod staircase end-to-end on the sparse-first path;
    device bytes an order of magnitude below dense-A bytes."""
    mod, (A, b, c, u) = _model(8192)
    mod.params.KKT.SparseFirst = True
    st = mod.optimize()
    assert st == TerminationStatus.OPTIMAL
    assert mod.kkt_backend.name == "sparse"
    z = tlp.get_attribute(mod, "ObjectiveValue")
    z_ref = highs_optimum(A, b, c, u)
    assert abs(z - z_ref) <= 1e-7 * max(1.0, abs(z_ref))
    # Storage accounting: compressed tile arrays vs the dense (m, n).
    res = sparse_lp_data_from_problem(mod.pbdata)
    assert res is not None
    dat, _, _ = res
    ntiles = dat.tile_brow.shape[0]
    nbr, B, smax = dat.Apc.shape
    device_bytes = (dat.Apc.size + ntiles * B * B
                    + 2 * ntiles * B * smax) * 8
    dense_bytes = dat.nrow * dat.ncol * 8
    assert device_bytes * 5 < dense_bytes

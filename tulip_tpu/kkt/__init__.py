"""KKT linear-system backends.

The IPM needs, at every iteration, solutions of the symmetric quasi-definite
**augmented system** (reference: src/KKT/KKT.jl:65-100)::

    [-(Θ⁻¹ + Rp)   Aᵀ] [dx]   [ξd]
    [   A          Rd] [dy] = [ξp]

Backends implement the reference's 3-function contract, re-designed as pure
functions over pytree state so that update/solve jit, vmap (scenario batches)
and shard (multi-chip) transparently:

- ``setup(A) -> state``: host-side; may run symbolic analysis. ``state`` is a
  pytree of device arrays.
- ``update(state, theta_inv, regP, regD) -> (state, ok)``: device-side
  numeric factorization. ``ok`` is a boolean scalar instead of the
  reference's PosDefException — exceptions don't exist inside jit, so the
  IPM's regularization-bump retry (reference: src/IPM/HSD/step.jl:34-51)
  branches on this flag with ``lax.while_loop``.
- ``solve(state, xi_p, xi_d) -> (dx, dy)``: device-side backsolves.

Backend objects themselves are immutable static configuration (hashable), so
they can be closed over / passed as static args to jit.

Systems (reference: src/KKT/systems.jl): K1 = normal equations
``(A(Θ⁻¹+Rp)⁻¹Aᵀ + Rd) dy = ...``; K2 = the augmented system itself.
"""

from __future__ import annotations

from typing import Dict, Type

from .banded import BandedK1Backend
from .base import KKTBackend
from .dense import DenseK1Backend
from .dense_ldl import DenseK2Backend
from .extended import ExtendedDDK1Backend, ExtendedK1Backend
from .krylov import (CarK1Backend, CgK1Backend, CraigK1Backend,
                     CraigmrK1Backend, CrK1Backend, LsmrK1Backend,
                     LsqrK1Backend,
                     MinaresK2Backend, MinresK2Backend, MinresQlpK2Backend,
                     SqdMinresK2Backend, SymmlqK2Backend, TricgK2Backend)
from .mixed import MixedK1Backend
from .schur import SchurK1Backend
from .sparse import SparseK1Backend
from .sparse_ldl import SparseK2Backend
from .splitting import SplitK1Backend

_REGISTRY: Dict[str, Type[KKTBackend]] = {}


def register(cls: Type[KKTBackend]) -> Type[KKTBackend]:
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (BandedK1Backend, DenseK1Backend, DenseK2Backend,
             ExtendedDDK1Backend, ExtendedK1Backend,
             CarK1Backend, CgK1Backend, CraigK1Backend, CraigmrK1Backend,
             CrK1Backend,
             LsmrK1Backend, LsqrK1Backend,
             MinaresK2Backend, MinresK2Backend, MinresQlpK2Backend,
             SqdMinresK2Backend, SymmlqK2Backend,
             TricgK2Backend,
             MixedK1Backend, SchurK1Backend,
             SparseK1Backend, SparseK2Backend, SplitK1Backend):
    register(_cls)


def available_backends() -> Dict[str, Type[KKTBackend]]:
    return dict(_REGISTRY)


def make_backend(name=None, system=None, refinement_steps: int = 0,
                 **kwargs) -> KKTBackend:
    """Instantiate a backend by name (default: dense K1, like the
    reference's Float64 default resolving to a direct method,
    reference: src/KKT/KKT.jl:134-141 — dense because a dense GEMM +
    Cholesky is the accelerator's native direct method)."""
    if name is None:
        name = "dense" if system in (None, "K1") else "dense-ldl"
    if name not in _REGISTRY:
        raise ValueError(f"unknown KKT backend {name!r}; available: "
                         f"{sorted(_REGISTRY)}")
    cls = _REGISTRY[name]
    if system is not None and system not in cls.systems:
        raise ValueError(f"backend {name!r} does not support system {system!r}")
    if cls.experimental:
        import warnings
        warnings.warn(
            f"KKT backend {name!r} is experimental: it passes the "
            "augmented-system conformance kit but is not validated for "
            "full 1e-8 end-to-end solves", stacklevel=2)
    return cls(refinement_steps=refinement_steps, **kwargs)


__all__ = [
    "KKTBackend",
    "BandedK1Backend",
    "DenseK1Backend",
    "DenseK2Backend",
    "ExtendedDDK1Backend",
    "ExtendedK1Backend",
    "CarK1Backend",
    "CgK1Backend",
    "CraigK1Backend",
    "CraigmrK1Backend",
    "CrK1Backend",
    "LsmrK1Backend",
    "LsqrK1Backend",
    "MinaresK2Backend",
    "MinresQlpK2Backend",
    "MinresK2Backend",
    "SqdMinresK2Backend",
    "SymmlqK2Backend",
    "TricgK2Backend",
    "MixedK1Backend",
    "SchurK1Backend",
    "SparseK1Backend",
    "SparseK2Backend",
    "SplitK1Backend",
    "make_backend",
    "available_backends",
    "register",
]

"""tulip_tpu — an interior-point linear-programming solver built on JAX/XLA.

A from-scratch re-design (not a port) of the capabilities of Tulip.jl
(reference: /root/reference, ds4dm/Tulip.jl v0.9.8):

- Homogeneous self-dual (HSD) primal-dual interior-point method with Mehrotra
  predictor-corrector and multiple centrality corrections, producing
  infeasibility / unboundedness certificates (reference: src/IPM/HSD/).
- Mehrotra predictor-corrector (MPC) variant (reference: src/IPM/MPC/).
- Swappable KKT linear-system backends behind a setup/update/solve contract
  (reference: src/KKT/KKT.jl:55-100).
- Host-side presolve/postsolve pipeline, MPS ingestion, attribute/parameter
  API (reference: src/Presolve/, src/Interfaces/).

Architecture: model building, presolve and symbolic analysis run on the
host; the per-iteration math runs as jitted device code over pytrees so it
vmaps (scenario batches) and shards (block-angular / multi-device) cleanly.
"""

import jax as _jax

# 64-bit floats are required to hit Tulip-parity 1e-8 tolerances. This must
# run before any JAX arrays are created, hence at package import.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from .status import TerminationStatus, SolutionStatus  # noqa: E402
from .params import Parameters, IPMOptions, KKTOptions, PresolveOptions  # noqa: E402
from .problem import ProblemData  # noqa: E402
from .solution import Solution  # noqa: E402
from .model import Model  # noqa: E402
from .api import (  # noqa: E402
    load_problem,
    get_parameter,
    set_parameter,
    get_attribute,
    set_attribute,
)
from .linprog import batch_linprog, linprog  # noqa: E402

__all__ = [
    "TerminationStatus",
    "SolutionStatus",
    "Parameters",
    "IPMOptions",
    "KKTOptions",
    "PresolveOptions",
    "ProblemData",
    "Solution",
    "Model",
    "load_problem",
    "get_parameter",
    "set_parameter",
    "get_attribute",
    "set_attribute",
    "linprog",
    "batch_linprog",
]


def version() -> str:
    return __version__

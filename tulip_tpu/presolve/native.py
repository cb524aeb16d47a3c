"""ctypes bindings for the native C++ presolve engine.

``native/presolve.cpp`` mirrors the Python pass loop
(:mod:`.presolve`, reference semantics: src/Presolve/Presolve.jl:374-463)
scan for scan, so both engines produce identical op streams and reduced
problems; the differential fuzz tests in tests/test_native_presolve.py
assert this. The wrapper runs the C engine on a :class:`PresolveData`
workspace and writes the result back into it, so ``extract_reduced_problem``
and ``postsolve`` work unchanged downstream.

Falls back silently when the library can't be built — callers use
:func:`native_available`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..solution import Solution
from ..status import SolutionStatus, TerminationStatus
from ..utils import native_library
from . import ops as OPS

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = native_library("libtulip_presolve.so")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.tlp_presolve_run.restype = ctypes.c_void_p
        lib.tlp_presolve_run.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P, _F64P,             # CSR
            _I32P, _I32P, _F64P,             # CSC
            _F64P, _F64P, _F64P, _F64P,      # lrow urow lcol ucol
            _F64P, ctypes.c_double,          # obj obj0
            ctypes.c_double, ctypes.c_double,
            _I32P, _I32P,                    # out_status, sizes
        ]
        lib.tlp_presolve_emit.restype = ctypes.c_int32
        lib.tlp_presolve_emit.argtypes = [
            ctypes.c_void_p,
            _U8P, _U8P,
            _F64P, _F64P, _F64P, _F64P,
            _F64P, _F64P,
            _I32P, _F64P,
            _I32P, _F64P,
        ]
        lib.tlp_presolve_free.restype = None
        lib.tlp_presolve_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _p(a, tp):
    return a.ctypes.data_as(tp)


def _decode_ops(n_ops: int, oi: np.ndarray, od: np.ndarray):
    """Decode the tagged op-log streams into the Python undo records
    (tags documented at the top of native/presolve.cpp)."""
    ops = []
    ip = dp = 0
    for _ in range(n_ops):
        tag = int(oi[ip]); ip += 1
        if tag == 0:
            ops.append(OPS.EmptyRow(int(oi[ip]), float(od[dp])))
            ip += 1; dp += 1
        elif tag == 1:
            ops.append(OPS.EmptyColumn(int(oi[ip]), float(od[dp]),
                                       float(od[dp + 1])))
            ip += 1; dp += 2
        elif tag == 2:
            j = int(oi[ip]); k = int(oi[ip + 1]); ip += 2
            idx = [int(v) for v in oi[ip:ip + k]]; ip += k
            x, c = float(od[dp]), float(od[dp + 1]); dp += 2
            val = [float(v) for v in od[dp:dp + k]]; dp += k
            ops.append(OPS.FixedVariable(j, x, c, (idx, val)))
        elif tag == 3:
            ops.append(OPS.RowSingleton(int(oi[ip]), int(oi[ip + 1]),
                                        float(od[dp]),
                                        bool(oi[ip + 2]), bool(oi[ip + 3])))
            ip += 4; dp += 1
        elif tag == 4:
            ops.append(OPS.DominatedRow(int(oi[ip])))
            ip += 1
        elif tag == 5:
            i = int(oi[ip]); at_lower = bool(oi[ip + 1])
            nr = int(oi[ip + 2]); ip += 3
            ridx = [int(v) for v in oi[ip:ip + nr]]; ip += nr
            cols_idx = []
            for _k in range(nr):
                clen = int(oi[ip]); ip += 1
                cols_idx.append([int(v) for v in oi[ip:ip + clen]])
                ip += clen
            rval = [float(v) for v in od[dp:dp + nr]]; dp += nr
            cols = []
            for cidx in cols_idx:
                cval = [float(v) for v in od[dp:dp + len(cidx)]]
                dp += len(cidx)
                cols.append((cidx, cval))
            xs = [float(v) for v in od[dp:dp + nr]]; dp += nr
            cs = [float(v) for v in od[dp:dp + nr]]; dp += nr
            ops.append(OPS.ForcingRow(i, at_lower, (ridx, rval), cols,
                                      xs, cs))
        elif tag == 6:
            i = int(oi[ip]); j = int(oi[ip + 1]); nr = int(oi[ip + 2])
            ip += 3
            ridx = [int(v) for v in oi[ip:ip + nr]]; ip += nr
            l, u, aij, y = (float(v) for v in od[dp:dp + 4]); dp += 4
            rval = [float(v) for v in od[dp:dp + nr]]; dp += nr
            ops.append(OPS.FreeColumnSingleton(i, j, l, u, aij, y,
                                               (ridx, rval)))
        elif tag == 7:
            j = int(oi[ip]); k = int(oi[ip + 1]); ip += 2
            idx = [int(v) for v in oi[ip:ip + k]]; ip += k
            x, cj = float(od[dp]), float(od[dp + 1]); dp += 2
            val = [float(v) for v in od[dp:dp + k]]; dp += k
            ops.append(OPS.DominatedColumn(j, x, cj, (idx, val)))
        else:  # pragma: no cover - protocol violation
            raise ValueError(f"bad op tag {tag}")
    return ops


def presolve_native(ps) -> Optional[TerminationStatus]:
    """Run the native pass loop on a freshly-initialized PresolveData.

    Returns the termination status and mutates ``ps`` to the post-presolve
    state (flags, bounds, objective, op stack, index maps, certificate
    solution), or ``None`` when the native library is unavailable — the
    caller then falls back to ``ps.presolve()``.
    """
    lib = _load()
    if lib is None:
        return None

    pb = ps.pb0
    m, n = pb.ncon, pb.nvar
    # CSR/CSC in the exact entry order of arows/acols (the Python engine's
    # iteration order — required for identical op streams).
    rp = np.zeros(m + 1, np.int32)
    for i, row in enumerate(pb.arows):
        rp[i + 1] = rp[i] + len(row.nzind)
    rj = np.asarray([j for row in pb.arows for j in row.nzind],
                    dtype=np.int32)
    rv = np.asarray([v for row in pb.arows for v in row.nzval],
                    dtype=np.float64)
    cp = np.zeros(n + 1, np.int32)
    for j, col in enumerate(pb.acols):
        cp[j + 1] = cp[j] + len(col.nzind)
    ci = np.asarray([i for col in pb.acols for i in col.nzind],
                    dtype=np.int32)
    cv = np.asarray([v for col in pb.acols for v in col.nzval],
                    dtype=np.float64)
    if rj.size == 0:
        rj = np.zeros(1, np.int32); rv = np.zeros(1, np.float64)
    if ci.size == 0:
        ci = np.zeros(1, np.int32); cv = np.zeros(1, np.float64)

    lrow = np.asarray(ps.lrow, np.float64)
    urow = np.asarray(ps.urow, np.float64)
    lcol = np.asarray(ps.lcol, np.float64)
    ucol = np.asarray(ps.ucol, np.float64)
    obj = np.asarray(ps.obj, np.float64)

    status = np.zeros(1, np.int32)
    sizes = np.zeros(5, np.int32)
    handle = lib.tlp_presolve_run(
        m, n, _p(rp, _I32P), _p(rj, _I32P), _p(rv, _F64P),
        _p(cp, _I32P), _p(ci, _I32P), _p(cv, _F64P),
        _p(lrow, _F64P), _p(urow, _F64P), _p(lcol, _F64P), _p(ucol, _F64P),
        _p(obj, _F64P), float(ps.obj0),
        float(ps.tol_pfeas), float(ps.tol_dfeas),
        _p(status, _I32P), _p(sizes, _I32P))
    if not handle:
        return None
    try:
        nrow_red, ncol_red, n_ops, oi_len, od_len = (int(v) for v in sizes)
        rowflag = np.zeros(m, np.uint8)
        colflag = np.zeros(n, np.uint8)
        obj0 = np.zeros(1, np.float64)
        oi = np.zeros(max(oi_len, 1), np.int32)
        od = np.zeros(max(od_len, 1), np.float64)
        cert_i = np.zeros(3, np.int32)
        cert_d = np.zeros(5, np.float64)
        lib.tlp_presolve_emit(
            handle, _p(rowflag, _U8P), _p(colflag, _U8P),
            _p(lrow, _F64P), _p(urow, _F64P), _p(lcol, _F64P),
            _p(ucol, _F64P), _p(obj, _F64P), _p(obj0, _F64P),
            _p(oi, _I32P), _p(od, _F64P), _p(cert_i, _I32P),
            _p(cert_d, _F64P))
    finally:
        lib.tlp_presolve_free(handle)

    # Write the final state back into the workspace.
    ps.rowflag = [bool(v) for v in rowflag]
    ps.colflag = [bool(v) for v in colflag]
    ps.lrow = lrow.tolist()
    ps.urow = urow.tolist()
    ps.lcol = lcol.tolist()
    ps.ucol = ucol.tolist()
    ps.obj = obj.tolist()
    ps.obj0 = float(obj0[0])
    ps.nrow = nrow_red
    ps.ncol = ncol_red
    ps.ops = _decode_ops(n_ops, oi, od)
    ps.status = TerminationStatus(int(status[0]))
    ps.compute_index_mapping()

    # Certificates / empty-problem solution (presolve.py:137-169, 631-638).
    kind = int(cert_i[0])
    if kind == 0:
        sol = Solution(ps.nrow, ps.ncol)
        ps.solution = sol
        sol.primal_status = SolutionStatus.UNKNOWN
        sol.dual_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.is_primal_ray = False
        sol.is_dual_ray = True
        sol.z_primal = sol.z_dual = float("inf")
        if int(cert_i[1]) >= 0:
            i_ = ps.new_con_idx[int(cert_i[1])]
            sol.y_lower[i_] = float(cert_d[0])
            sol.y_upper[i_] = float(cert_d[1])
        if int(cert_i[2]) >= 0:
            j_ = ps.new_var_idx[int(cert_i[2])]
            sol.s_lower[j_] = float(cert_d[2])
            sol.s_upper[j_] = float(cert_d[3])
    elif kind == 1:
        sol = Solution(ps.nrow, ps.ncol)
        ps.solution = sol
        sol.primal_status = SolutionStatus.INFEASIBILITY_CERTIFICATE
        sol.dual_status = SolutionStatus.UNKNOWN
        sol.is_primal_ray = True
        sol.is_dual_ray = False
        sol.z_primal = sol.z_dual = -float("inf")
        sol.x[ps.new_var_idx[int(cert_i[2])]] = float(cert_d[4])
    elif ps.status == TerminationStatus.OPTIMAL:
        sol = Solution(0, 0)
        ps.solution = sol
        sol.primal_status = SolutionStatus.OPTIMAL
        sol.dual_status = SolutionStatus.OPTIMAL
        sol.z_primal = ps.obj0
        sol.z_dual = ps.obj0

    return ps.status

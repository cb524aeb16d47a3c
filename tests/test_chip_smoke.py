"""chip_smoke.py without a card: it refuses to run, and its independent
checks accept true answers and reject perturbed ones."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import card  # noqa: E402
import chip_smoke as cs  # noqa: E402


def test_main_exits_nonzero_without_nvidia_smi(monkeypatch, capsys):
    def no_smi():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(card, "gpu_card_info", no_smi)
    assert cs.main(["--four-cards"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_main_exits_nonzero_when_jax_has_no_gpu(monkeypatch, capsys):
    """A card that nvidia-smi sees is not enough: JAX must run on it."""
    monkeypatch.setattr(card, "gpu_card_info", lambda: "Some GPU, 700.00 W")
    assert cs.main(["--four-cards"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_format():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("tail,ok", [
    ("3 passed in 4.1s", True),
    ("2 passed, 1 skipped in 4.1s", False),
    ("1 failed, 2 passed in 4.1s", False),
    ("3 deselected in 1.0s", False),
])
def test_gpu_tests_phase_needs_every_test_to_pass(monkeypatch, tail, ok):
    def fake_run(cmd, **kw):
        assert kw["env"]["JAX_PLATFORMS"] == "cuda"
        assert "-m" in cmd and "gpu" in cmd
        return types.SimpleNamespace(returncode=0, stdout=f"...\n{tail}\n",
                                     stderr="")

    monkeypatch.setattr(cs.subprocess, "run", fake_run)
    if ok:
        assert cs.run_phase("gpu-tests", "card", cs.phase_gpu_tests) \
            == {"passed": 3}
    else:
        with pytest.raises(AssertionError):
            cs.run_phase("gpu-tests", "card", cs.phase_gpu_tests)


@pytest.fixture(scope="module")
def solved_staircase():
    from tulip_tpu.status import TerminationStatus

    A, b, c, u = cs.staircase(128)
    mod = cs.load_staircase(A, b, c, u, "stair128")
    assert mod.optimize() == TerminationStatus.OPTIMAL
    return A, b, c, u, mod.solution


@pytest.mark.parametrize("perturb", ["none", "x", "y", "s"])
def test_host_check(solved_staircase, perturb):
    """Accepts the solver's optimal pair, rejects one perturbed in x, in
    the row duals or in the bound duals."""
    import copy

    A, b, c, u, sol = solved_staircase
    sol = copy.deepcopy(sol)
    if perturb == "x":
        sol.x[3] += 1e-3
    elif perturb == "y":
        sol.y_lower[5] += 1e-3
    elif perturb == "s":
        sol.s_upper[7] += 1e-3
    n = A.shape[1]
    errs = cs.host_check(A, b, b, np.zeros(n), u, c, sol)
    assert (max(errs.values()) <= 1e-6) == (perturb == "none"), errs


def test_farkas_check_on_infeasible_fixture():
    import copy

    import tulip_tpu as tlp
    from tulip_tpu.status import TerminationStatus

    mod = tlp.Model()
    tlp.load_problem(mod, os.path.join(ROOT, "tests", "data", "lp_inf.mps"))
    assert mod.optimize() == TerminationStatus.PRIMAL_INFEASIBLE
    A, lcon, ucon, lvar, uvar, _ = cs.problem_arrays(mod.pbdata)
    resid, dobj = cs.farkas_check(A, lcon, ucon, lvar, uvar, mod.solution)
    assert resid <= 1e-6 and dobj > 0
    bad = copy.deepcopy(mod.solution)
    bad.s_lower[:] += 0.5
    resid, _ = cs.farkas_check(A, lcon, ucon, lvar, uvar, bad)
    assert resid > 1e-6


def test_kernel_share_takes_union_of_intervals():
    events = [
        ("potrf_batched custom-call.1", 0, 10),
        ("trsm_kernel triangular-solve.2", 5, 15),     # overlaps the first
        ("gemm fusion.3", 20, 40),
        ("loop_fusion fusion.4", 30, 50),
    ]
    chol, busy, top = cs.kernel_share(events)
    assert chol == 15 and busy == 45
    assert top[0][0] == "gemm fusion.3"


def test_collective_sizes_parses_hlo():
    hlo = "\n".join([
        "  %all-reduce.1 = f64[128,128]{1,0} all-reduce(f64[128,128] %x)",
        "  %all-gather.2 = f32[4,16]{1,0} all-gather(f32[1,16] %y)",
        "  %add.3 = f64[128]{0} add(%a, %b)",
        "  %all-reduce.4 = f64[] all-reduce(f64[] %z)",
    ])
    assert cs.collective_sizes(hlo) == [("all-reduce", 128 * 128),
                                        ("all-gather", 64),
                                        ("all-reduce", 1)]


def test_report_line_carries_card(capsys):
    cs.report("cli", "NVIDIA H100 80GB HBM3, 700.00 W", err=1e-9,
              compile_s=1.5, solve_s=0.25)
    line = capsys.readouterr().out.strip()
    assert re.match(r"\[cli\] OK .*err=1e-09.*compile_s=1\.5.*solve_s=0\.25"
                    r".*card=\"NVIDIA H100 80GB HBM3, 700\.00 W\"$", line)

"""Entry-point contract tests.

The entry points other programs run from this repo:

- ``bench.py``            -> prints ONE JSON line, no matter what
                             (these tests pin the budget and
                             signal-abort emission paths), and fails
                             without a GPU unless ``--cpu``.
- ``chip_smoke.py``       -> exits non-zero with no result line where
                             there is no GPU or no repository.
- ``__graft_entry__.entry``            -> jittable single-device forward.
- ``__graft_entry__.dryrun_multichip`` -> 8-virtual-device sharded step.

Reference analog for the bench contract: the always-available
samples/sec printout, src/RendererPT.cpp:599-605.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_lines(stdout: str):
    out = []
    for line in stdout.strip().splitlines():
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def _scrubbed_env():
    """Subprocess env for CPU bench runs: drop the conftest's virtual
    8-device XLA_FLAGS (bench must behave as it does under the driver,
    which invokes it with a clean env)."""
    env = dict(os.environ)
    for var in ("XLA_FLAGS", "LPT_GPU_TESTS", "LPT_BENCH_BUDGET_S"):
        env.pop(var, None)
    return env


def _check_result_schema(res):
    assert res["metric"] == "mrays_per_sec_chip_cornell"
    assert res["unit"] == "Mrays/s"
    assert set(res) >= {"metric", "value", "unit", "vs_baseline",
                        "extras"}


def test_bench_quick_cpu_one_json_line():
    """`python bench.py --quick --cpu` emits exactly one parseable
    JSON line with the contract fields and a real measured value."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--quick", "--cpu"],
        capture_output=True, text=True, timeout=900,
        env=_scrubbed_env(), cwd=REPO)
    lines = _json_lines(proc.stdout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(lines) == 1, proc.stdout
    res = lines[0]
    _check_result_schema(res)
    assert isinstance(res["value"], (int, float)) and res["value"] > 0
    assert res["extras"]["resolution"] == "128x128"


def test_bench_budget_exhausted_still_emits():
    """With an impossible budget the orchestrator still prints its one
    JSON line (value null, note explains) and exits 0 fast."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--quick", "--cpu", "--budget", "8"],
        capture_output=True, text=True, timeout=120,
        env=_scrubbed_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = _json_lines(proc.stdout)
    assert len(lines) == 1, proc.stdout
    res = lines[0]
    _check_result_schema(res)
    assert res["value"] is None
    assert "note" in res["extras"]
    assert time.time() - t0 < 60


def test_bench_sigterm_emits_line():
    """SIGTERM mid-run (the driver's `timeout` kill) still produces
    the one JSON line and leaves no orphan stage subprocess."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--quick", "--cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_scrubbed_env(), cwd=REPO)
    time.sleep(20)  # mid-headline (warmup compile is ~40 s on CPU)
    proc.send_signal(signal.SIGTERM)
    stdout, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = _json_lines(stdout)
    assert len(lines) == 1, stdout
    _check_result_schema(lines[0])


def test_bench_without_gpu_fails():
    """Without --cpu, a stage that finds no GPU fails the run (exit 2)
    and the one line carries no value."""
    env = _scrubbed_env()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--quick"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 2, proc.stderr[-2000:]
    lines = _json_lines(proc.stdout)
    assert len(lines) == 1, proc.stdout
    _check_result_schema(lines[0])
    assert lines[0]["value"] is None
    assert "no GPU" in lines[0]["extras"]["note"]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py prints no result line and exits non-zero on a host
    without a GPU, and in a directory holding nothing else of the
    repository."""
    import shutil
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = _scrubbed_env()
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)
    assert proc.returncode != 0
    assert not _json_lines(proc.stdout), proc.stdout


def test_graft_entry_fn_runs():
    """__graft_entry__.entry() returns a jittable fn + args that
    compile and execute on this (CPU) backend."""
    import jax
    import numpy as np

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    fn, example_args = ge.entry()
    out = jax.jit(fn)(*example_args)
    out = jax.tree_util.tree_leaves(out)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in out)


def test_dryrun_multichip_8(tmp_path):
    """dryrun_multichip(8) self-provisions the virtual mesh and runs a
    sharded step — in a subprocess, because it mutates XLA_FLAGS and
    must init its own backend (mirrors the driver's invocation)."""
    code = ("import __graft_entry__ as ge; ge.dryrun_multichip(8); "
            "print('DRYRUN_OK')")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=900, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DRYRUN_OK" in proc.stdout

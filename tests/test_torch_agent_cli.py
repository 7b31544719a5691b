"""The port's agent CLIs in-process on the CPU (tiny_llm_tpu_torch.agent_main,
tiny_llm_tpu_torch.evaluate_agent) on the tiny real checkpoint, and the
agent where JAX cannot be imported: the package and both CLIs import, and
two of the JAX agent test files' port copies pass with `jax` blocked."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from tiny_llm_tpu_torch import agent_main, evaluate_agent  # noqa: E402

from .torch_port import real_checkpoint, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = Path(__file__).resolve().parents[1]
PACKAGE = str(REPO / "evals" / "localized-constant")


@pytest.fixture(scope="module")
def ckpt() -> list[str]:
    return ["--device", "cpu", "--checkpoint-path", real_checkpoint("qwen3-tiny-real")]


def test_agent_main_runs_a_task(ckpt, tmp_path, capsys):
    """One step on a random-weights checkpoint: the run ends (most likely on
    an invalid action), prints its status line, and with a session store
    leaves a session file that replays."""
    (tmp_path / "a.txt").write_text("hello\n")
    runs = agent_main.main([*ckpt, "--root", str(tmp_path), "--yes", "--max-steps", "1",
                            "--max-tokens", "8", "say hello"])
    assert len(runs) == 1 and runs[0].steps == 1
    assert runs[0].status in ("final", "step_limit", "invalid_limit", "loop")
    out = capsys.readouterr()
    assert f"[{runs[0].status} after 1 steps]" in out.out
    assert "session: " in out.err
    from tiny_llm_tpu_torch.agent import SessionStore

    latest = SessionStore(str(tmp_path)).latest()
    assert [e.type for e in latest.events][:2] == [e.type for e in runs[0].session.events][:2]
    assert agent_main.main([*ckpt, "--root", str(tmp_path), "--no-session", "--max-steps", "1",
                            "--max-tokens", "4", "--paged", "again"])[0].steps == 1


def test_agent_main_rejects_bad_flags(ckpt):
    with pytest.raises(SystemExit):
        agent_main.main([*ckpt])  # neither a task nor --interactive
    with pytest.raises(SystemExit):
        agent_main.main([*ckpt, "--impl", "pallas", "task"])
    with pytest.raises(SystemExit):
        agent_main.main(["--device", "tpu", "task"])


def test_evaluate_agent_inspect_and_grade(capsys):
    manifest = evaluate_agent.main(["inspect", PACKAGE])
    assert manifest["id"] == "localized-constant"
    assert json.loads(capsys.readouterr().out) == manifest
    results = evaluate_agent.main(["grade", PACKAGE])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == (f"{sum(r.passed for r in results)}/{len(results)} checks pass "
                       "on the pristine workspace")
    assert not all(r.passed for r in results)  # the task is not done in the pristine tree


def test_evaluate_agent_run(ckpt, capsys):
    report = evaluate_agent.main(["run", PACKAGE, *ckpt, "--max-steps", "1"])
    assert report["task_id"] == "localized-constant" and report["metrics"]["steps"] == 1
    assert not report["passed"]
    assert json.loads(capsys.readouterr().out)["status"] == report["status"]


def test_agent_runs_with_jax_unimportable():
    """With `jax` unimportable: the port's agent and its CLIs import, and the
    port copies of tests/test_agent_core.py and tests/test_agent_loop.py
    pass under pytest without the suite's conftest (which imports JAX);
    nothing of the JAX package is imported."""
    code = """
import sys
for name in list(sys.modules):
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
        sys.modules[name] = None
sys.modules["jax"] = None
import pytest
import tiny_llm_tpu_torch.agent, tiny_llm_tpu_torch.agent_main, tiny_llm_tpu_torch.evaluate_agent


class Passes:
    n = 0

    def pytest_runtest_logreport(self, report):
        Passes.n += report.when == "call" and report.passed


rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                  "-p", "no:xdist", "tests/test_torch_agent_core.py",
                  "tests/test_torch_agent_loop.py"], plugins=[Passes()])
assert not any(n == "tiny_llm_tpu" or n.startswith("tiny_llm_tpu.") for n in sys.modules)
print("PASSES", Passes.n)
sys.exit(int(rc))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-2000:])
    collected = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-qq", "-p", "no:cacheprovider",
         "tests/test_agent_core.py", "tests/test_agent_loop.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300).stdout
    jax_cases = sum(int(m) for m in re.findall(r"^tests/test_agent_\w+\.py: (\d+)$", collected,
                                              re.M))
    assert r.stdout.strip().splitlines()[-1] == f"PASSES {jax_cases}" and jax_cases > 40

"""The port's agent against the JAX package's on the same inputs: the
action parser, the system prompt, compaction and context decisions, the
workspace tools, evaluate_task on the three evals/ packages, and a
four-turn GenerationSession (cold, reuse, rewind, replay) on the same
bridged weights, dense and paged."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import tiny_llm_tpu.agent as J  # noqa: E402
from tiny_llm_tpu.agent import context as jax_context  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params, tiny_test_config  # noqa: E402

import tiny_llm_tpu_torch.agent as P  # noqa: E402
from tiny_llm_tpu_torch.agent import context as port_context  # noqa: E402

from .torch_agent_models import Qwen3Model as port_model  # noqa: E402
from .torch_port import torch_one_thread  # noqa: E402,F401
from .utils import FakeTokenizer  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = Path(__file__).resolve().parents[1]
EVALS = sorted(p.name for p in (REPO / "evals").iterdir() if (p / "task.json").exists())


def _outcome(pkg, fn, *args):
    """(kind, value): the result as plain data, or the error's type and text."""
    try:
        out = fn(*args)
    except pkg.AgentError as e:
        return ("AgentError", str(e))
    except Exception as e:  # noqa: BLE001 - the exception is the outcome compared
        return (type(e).__name__, str(e))
    return (type(out).__name__, dataclasses.asdict(out) if dataclasses.is_dataclass(out)
            else out)


ACTIONS = [
    '{"type": "final", "message": "done"}',
    '  {"type": "final", "message": "ünïcode ✓"}\n',
    '```json\n{"type": "tool", "tool": "read_file", "path": "a.py"}\n```',
    '```\n{"type": "tool", "tool": "list_files", "path": "."}\n```',
    '{"type": "tool", "tool": "write_file", "path": "x", "content": "y"}',
    '{"type": "tool", "tool": "edit_file", "path": "x", "old": "a", "new": "b"}',
    '{"type": "tool", "tool": "run_command", "argv": ["python", "-c", "1"]}',
    '{"type": "final", "message": "a"} {"type": "final", "message": "b"}',
    '{"type": "final", "message": "a"}{"type": "final", "message": "b"}',
    'Sure! {"type": "final", "message": "a"}',
    '{"type": "final", "message": "a"} thanks',
    "",
    "not json at all",
    "[1, 2, 3]",
    '{"type": "final"}',
    '{"type": "final", "message": 3}',
    '{"type": "final", "message": "a", "extra": 1}',
    '{"type": "tool", "tool": "rm_rf", "path": "/"}',
    '{"type": "tool", "tool": "read_file"}',
    '{"type": "tool", "tool": "read_file", "path": 7}',
    '{"type": "tool", "tool": "read_file", "path": "a", "mode": "r"}',
    '{"type": "tool", "tool": "run_command", "argv": []}',
    '{"type": "tool", "tool": "run_command", "argv": ["ls", 3]}',
    '{"type": "tool", "tool": "run_command", "argv": "ls"}',
    '{"type": "answer", "message": "a"}',
    '{"message": "a"}',
    '{"type": "final", "message": "unterminated',
]


@pytest.mark.parametrize("i", range(len(ACTIONS)))
def test_parse_action_matches_jax(i):
    text = ACTIONS[i]
    assert _outcome(P, P.parse_action, text) == _outcome(J, J.parse_action, text)


POLICIES = [
    dict(),
    dict(allow_writes=True),
    dict(allowed_commands=(("python", "-c"), ("ls",))),
    dict(allow_writes=True, allowed_commands=(("git", "status"),)),
]


@pytest.mark.parametrize("i", range(len(POLICIES)))
@pytest.mark.parametrize("extra", [None, "Use tabs."])
def test_system_prompt_matches_jax(tmp_path, i, extra):
    kw = POLICIES[i]
    got = P.build_system_prompt(P.ToolPolicy(root=str(tmp_path), **kw), extra)
    want = J.build_system_prompt(J.ToolPolicy(root=str(tmp_path), **kw), extra)
    assert got == want


def _conversation(turns: int, width: int) -> list[dict]:
    msgs = [{"role": "user", "content": "goal: fix the retry limit " * 3}]
    for t in range(turns):
        msgs.append({"role": "assistant",
                     "content": json.dumps({"type": "tool", "tool": "read_file",
                                            "path": f"f{t}.py"})})
        msgs.append({"role": "user", "content": f"tool_result: {t} " + "x" * width})
    return msgs


def _events(session) -> list[tuple]:
    return [(e.type, e.data) for e in session.events]


@pytest.mark.parametrize("turns,width", [(2, 10), (6, 400), (12, 3000)])
@pytest.mark.parametrize("summarizer", ["deterministic", "model", "failing"])
def test_context_decisions_match_jax(turns, width, summarizer):
    """compact_messages and ContextManager.prepare (bounded tool results,
    compaction with each kind of summarizer, the durable events) give the
    same messages and session events in both packages."""
    msgs = _conversation(turns, width)
    assert port_context.compact_messages(msgs, 2000) == jax_context.compact_messages(msgs, 2000)
    outs = []
    for pkg, ctx_mod in ((P, port_context), (J, jax_context)):
        def model(old, pkg=pkg):
            if summarizer == "failing":
                raise RuntimeError("summarizer down")
            return pkg.WorkingSummary(goal=old[0]["content"][:40], facts=[str(len(old))])

        session = pkg.memory_session()
        cm = pkg.ContextManager(
            encode=lambda s: len(FakeTokenizer().encode(s)),
            policy=pkg.ContextPolicy(max_tokens=3000, reserve_output=500,
                                     max_summary_tokens=200, max_tool_result_tokens=600),
            summarize=None if summarizer == "deterministic" else model,
            session_log=session)
        try:
            out = cm.prepare(msgs)
        except ctx_mod.ContextLimitError as e:
            out = ("ContextLimitError", str(e))
        outs.append((out, cm.compactions, _events(session)))
    assert outs[0] == outs[1]


def _tree(root: Path) -> Path:
    (root / "src").mkdir(parents=True)
    (root / "src" / "a.py").write_text("RETRY = 3\nNAME = 'a'\n")
    (root / "notes.md").write_text("# notes\n" + "line\n" * 50)
    (root / "data.bin").write_bytes(bytes(range(256)))
    return root


WORKSPACE_ACTIONS = [
    ("list_files", {"path": "."}),
    ("list_files", {"path": "src"}),
    ("read_file", {"path": "src/a.py"}),
    ("read_file", {"path": "data.bin"}),
    ("read_file", {"path": "../etc/passwd"}),
    ("read_file", {"path": "/etc/passwd"}),
    ("read_file", {"path": "missing.py"}),
    ("edit_file", {"path": "src/a.py", "old": "RETRY = 3", "new": "RETRY = 5"}),
    ("edit_file", {"path": "src/a.py", "old": "absent", "new": "x"}),
    ("write_file", {"path": "notes.md", "content": "unread write"}),
    ("read_file", {"path": "notes.md"}),
    ("write_file", {"path": "notes.md", "content": "# rewritten\n"}),
    ("write_file", {"path": "src/new.py", "content": "X = 1\n"}),
    ("run_command", {"argv": [sys.executable, "-c", "print(6 * 7)"]}),
    ("run_command", {"argv": ["ls", "-la"]}),
    ("read_file", {"path": "src/a.py"}),
]


def test_workspace_tools_match_jax(tmp_path):
    """The same actions on two identical trees through each package's
    Workspace (writes allowed, one command allowed, a journal): equal
    observations (the roots' paths replaced), equal trees after."""
    obs = []
    for name, pkg in (("port", P), ("jax", J)):
        root = _tree(tmp_path / name)
        session = pkg.memory_session()
        policy = pkg.ToolPolicy(root=str(root), allow_writes=True,
                                allowed_commands=((sys.executable, "-c"),))
        ws = pkg.Workspace(policy, session_log=session,
                           journal=pkg.MutationJournal(session, str(root)),
                           confirm=lambda action: True)
        seen = []
        for tool, args in WORKSPACE_ACTIONS:
            out = ws.execute(pkg.ToolAction(tool=tool, args=args))
            out = {k: v for k, v in out.items() if k != "seconds"}
            seen.append(json.loads(json.dumps(out, sort_keys=True, default=str)
                                   .replace(str(root), "<root>")))
        files = {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                 if p.is_file() and ".tiny-llm-tpu" not in p.parts}
        obs.append((seen, files))
    assert obs[0] == obs[1]


SCRIPTS = {
    "localized-constant": [
        '{"type": "tool", "tool": "read_file", "path": "settings.py"}',
        'I will edit it now.',
        '{"type": "tool", "tool": "edit_file", "path": "settings.py", '
        '"old": "RETRY_LIMIT = 3", "new": "RETRY_LIMIT = 5"}',
        '{"type": "final", "message": "RETRY_LIMIT is 5"}',
    ],
    "failure-recovery": [
        '{"type": "tool", "tool": "read_file", "path": "state.json"}',
        '{"type": "tool", "tool": "write_file", "path": "state.json", '
        '"content": "{\\"job_id\\": \\"j-4821\\", \\"status\\": \\"clean\\"}"}',
        '{"type": "final", "message": "repaired"}',
    ],
    "repository-convention": [
        '{"type": "tool", "tool": "read_file", "path": "src/farewell.py"}',
        '{"type": "tool", "tool": "write_file", "path": "src/greetings.py", '
        '"content": "\\"\\"\\"Greeting strings.\\"\\"\\"\\n\\nGREETING = \\"hello\\"\\n"}',
        '{"type": "tool", "tool": "write_file", "path": "notes.txt", "content": "x"}',
        '{"type": "final", "message": "added"}',
    ],
}


def _scripted(replies):
    """One scripted `generate`: the next reply each call, with stats."""
    it = iter(replies)

    def generate(messages):
        text = next(it)
        return text, SimpleNamespace(input_tokens=len(json.dumps(messages)),
                                     output_tokens=len(text))

    return generate


@pytest.mark.parametrize("task", EVALS)
def test_evaluate_task_matches_jax(task, tmp_path):
    """evaluate_task on the evals/ package with the same scripted replies:
    equal reports (status, checks, metrics), the work directories apart."""
    reports = []
    for name, pkg in (("port", P), ("jax", J)):
        package = pkg.TaskPackage.load(str(REPO / "evals" / task))
        (tmp_path / name).mkdir()
        report = pkg.evaluate_task(package, _scripted(SCRIPTS[task]),
                                   workdir=str(tmp_path / name))
        report.pop("workdir")
        reports.append(json.loads(json.dumps(report, sort_keys=True, default=str)))
    assert reports[0] == reports[1]
    assert reports[0]["status"] == "final"


# ---------------------------------------------------------------------------
# GenerationSession on the same bridged weights.
# ---------------------------------------------------------------------------


def _msgs(*contents):
    out = [{"role": "user", "content": contents[0]}]
    for i, c in enumerate(contents[1:]):
        out.append({"role": "assistant" if i % 2 == 0 else "user", "content": c})
    return out


@pytest.fixture(scope="module")
def models():
    cfg = tiny_test_config(num_hidden_layers=2)
    params = random_params(cfg, key=0)
    out = {}
    for mode in ("dense", "paged"):
        jm, pm = JaxQwen3Model(params, cfg, max_seq_len=256), port_model(params, cfg, 256)
        if mode == "paged":
            jm.enable_paged_attention(num_pages=40, page_size=16)
            pm.enable_paged_attention(num_pages=40, page_size=16)
        out[mode] = (jm, pm)
    return out


def _four_turns(model, pkg, chunk):
    """Cold; an appended reply and observation (reuse); the last user
    message edited (rewind); the same messages again (replay)."""
    sess = pkg.GenerationSession(model, FakeTokenizer(), max_tokens=8, prefill_chunk=chunk)
    out1, s1 = sess(_msgs("hello there"))
    turns = [(out1, s1)]
    for convo in (_msgs("hello there", out1, "tool_result: ok, tell me more"),
                  _msgs("hello there", out1, "tool_result: no, tell me less"),
                  _msgs("hello there", out1, "tool_result: no, tell me less")):
        turns.append(sess(convo))
    live = model.page_pool.live_pages if model.page_pool is not None else None
    sess.reset()
    return [(t, {k: v for k, v in dataclasses.asdict(s).items() if k != "latency_s"})
            for t, s in turns], live


@pytest.mark.parametrize("chunk", [256, 16])
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_four_turn_session_matches_jax(models, mode, chunk):
    """Texts and GenerationStats (latency apart) equal the JAX package's on
    every turn; the warm turns reuse, rewind and replay as the stats say,
    and a paged session returns every page on reset. (The reply's tokens
    do not survive FakeTokenizer's decode and encode, so the reuse turn
    rewinds them: JAX's session does the same.)"""
    jm, pm = models[mode]
    got, live_p = _four_turns(pm, P, chunk)
    want, live_j = _four_turns(jm, J, chunk)
    assert got == want
    stats = [s for _, s in got]
    assert stats[0]["cold_start"] and not any(s["cold_start"] for s in stats[1:])
    assert stats[1]["reused_tokens"] >= stats[0]["input_tokens"]
    assert stats[2]["rewound_tokens"] > 0
    assert stats[3]["prefilled_tokens"] == 1 and stats[3]["rewound_tokens"] == 1 + stats[2][
        "output_tokens"]
    if mode == "paged":
        assert live_p == live_j > 0
        assert pm.page_pool.live_pages == jm.page_pool.live_pages == 0

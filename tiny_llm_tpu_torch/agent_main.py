"""Coding-agent CLI — counterpart of agent.py.

    python -m tiny_llm_tpu_torch.agent_main "<task>" [--interactive] [--root DIR]
        [--model qwen3-0.6b] [--checkpoint-path DIR] [--paged] [--allow-writes]
        [--allow-command "ARGV PREFIX"] [--yes] [--max-steps N] [--max-tokens N]
        [--continue | --session ID | --no-session] [--impl cuda|torch] [--device cuda|cpu]

One-shot task or interactive REPL over a sandboxed workspace, with session
persistence/resume, y/N confirmation of side effects, and KV-prefix-reuse
generation (agent.GenerationSession) on the port's model at max_seq_len
4096. Works with a real checkpoint or synthetic weights (protocol
smoke-testing). Runs on the card unless --device cpu. The module is
`agent_main` because `tiny_llm_tpu_torch.agent` is the package.
"""

from __future__ import annotations

import argparse
import sys

from .agent import (
    AgentLimits,
    AgentRun,
    ContextManager,
    ContextPolicy,
    GenerationSession,
    MutationJournal,
    SessionStore,
    ToolPolicy,
    Workspace,
    memory_session,
    run_agent,
)
from .agent.context import model_summarizer

# agent.py's context length: the system prompt, the task and the tool
# observations of a few steps.
MAX_SEQ_LEN = 4096


def human_confirm(action) -> bool:
    args_preview = str(action.args)[:200]
    answer = input(f"allow {action.tool} {args_preview}? [y/N] ").strip().lower()
    return answer == "y"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run the coding agent with a Qwen3 model on one GPU.")
    p.add_argument("task", nargs="?", help="one-shot task text")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--root", default=".", help="workspace root")
    p.add_argument("--model", default="qwen3-0.6b")
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--paged", action="store_true")
    p.add_argument("--allow-writes", action="store_true")
    p.add_argument("--allow-command", action="append", default=[],
                   help="exact argv prefix, space separated; repeatable")
    p.add_argument("--yes", action="store_true",
                   help="auto-approve side effects (non-interactive runs)")
    p.add_argument("--max-steps", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=512)
    p.add_argument("--continue", dest="cont", action="store_true",
                   help="resume the latest session")
    p.add_argument("--session", default=None, help="resume a specific session id")
    p.add_argument("--no-session", action="store_true",
                   help="ephemeral in-memory session")
    p.add_argument("--impl", default=None, choices=["cuda", "torch"],
                   help="torch: the kernels' plain PyTorch versions")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv: list[str] | None = None) -> list[AgentRun]:
    """Parse `argv` (sys.argv when None), run the task (or each task of the
    REPL) and return the runs."""
    p = parser()
    args = p.parse_args(argv)
    if not args.task and not args.interactive:
        p.error("provide a task or --interactive")

    from .main import build_model

    model, tok = build_model(args.model, args.checkpoint_path, MAX_SEQ_LEN, args.paged,
                             args.impl, args.device)
    gen_session = GenerationSession(model, tok, max_tokens=args.max_tokens)

    def generate(messages):
        return gen_session(messages)

    policy = ToolPolicy(
        root=args.root,
        allow_writes=args.allow_writes,
        allowed_commands=tuple(tuple(c.split()) for c in args.allow_command),
    )
    if args.no_session:
        session = memory_session()
    else:
        store = SessionStore(args.root)
        if args.session:
            session = store.load(args.session)
        elif args.cont:
            session = store.latest() or store.create()
        else:
            session = store.create()
        print(f"session: {store.session_id(session)}", file=sys.stderr)

    journal = MutationJournal(session, policy.root)
    recovered = journal.recover_pending()
    if recovered:
        print(f"recovered {len(recovered)} pending mutations: {recovered}",
              file=sys.stderr)
    confirm = (lambda a: True) if args.yes else human_confirm
    workspace = Workspace(
        policy, session_log=session, journal=journal, confirm=confirm
    )
    # The summarizer runs in a SEPARATE generation session so compaction
    # never disturbs the main conversation's KV prefix.
    summarizer_session = GenerationSession(model, tok, max_tokens=512)
    ctx = ContextManager(
        encode=lambda s: len(tok.encode(s)),
        policy=ContextPolicy(),
        summarize=model_summarizer(summarizer_session),
        session_log=session,
    )
    limits = AgentLimits(max_steps=args.max_steps)
    runs: list[AgentRun] = []

    def run_one(task: str) -> None:
        run = run_agent(
            task, generate, workspace, limits=limits, session=session,
            context_manager=ctx,
        )
        runs.append(run)
        print(f"[{run.status} after {run.steps} steps]")
        if run.final_message:
            print(run.final_message)

    if args.interactive:
        print("interactive agent; empty line to exit", file=sys.stderr)
        while True:
            try:
                task = input("task> ").strip()
            except EOFError:
                break
            if not task:
                break
            run_one(task)
    else:
        run_one(args.task)
    return runs


if __name__ == "__main__":
    main()

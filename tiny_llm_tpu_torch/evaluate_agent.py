"""Agent evaluation CLI — counterpart of evaluate-agent.py.

    python -m tiny_llm_tpu_torch.evaluate_agent inspect PACKAGE
    python -m tiny_llm_tpu_torch.evaluate_agent grade PACKAGE
    python -m tiny_llm_tpu_torch.evaluate_agent run PACKAGE [--model qwen3-0.6b]
        [--checkpoint-path DIR] [--max-steps N] [--impl cuda|torch] [--device cuda|cpu]

`inspect` prints the manifest and checks; `grade` stages + freezes +
grades the untouched package (all checks against the pristine
workspace); `run` evaluates a model-driven agent on the package, the
model built as agent_main builds it (on the card unless --device cpu).
"""

from __future__ import annotations

import argparse
import json

from .agent import AgentLimits, GenerationSession, TaskPackage, evaluate_task
from .agent.evaluation import StagedTask, StaticHeldOutGrader


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inspect, grade or run a sealed agent task package.")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("inspect")
    pi.add_argument("package")

    pg = sub.add_parser("grade")
    pg.add_argument("package")

    pr = sub.add_parser("run")
    pr.add_argument("package")
    pr.add_argument("--model", default="qwen3-0.6b")
    pr.add_argument("--checkpoint-path", default=None)
    pr.add_argument("--max-steps", type=int, default=8)
    pr.add_argument("--impl", default=None, choices=["cuda", "torch"],
                    help="torch: the kernels' plain PyTorch versions")
    pr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv: list[str] | None = None):
    """Parse `argv` (sys.argv when None) and run the command; returns what it
    printed as data: the manifest (inspect), the check results (grade) or
    the report (run)."""
    args = parser().parse_args(argv)
    package = TaskPackage.load(args.package)

    if args.cmd == "inspect":
        manifest = {
            "id": package.task_id,
            "instructions": package.instructions,
            "editable_paths": list(package.editable_paths),
            "checks": list(package.checks),
        }
        print(json.dumps(manifest, indent=2))
        return manifest

    if args.cmd == "grade":
        staged = StagedTask.stage(package)
        results = StaticHeldOutGrader(package, staged.original).grade(
            staged.freeze()
        )
        for r in results:
            mark = "PASS" if r.passed else "FAIL"
            print(f"{mark} {r.check['type']} {r.check.get('path', '')} {r.detail}")
        print(f"{sum(r.passed for r in results)}/{len(results)} checks pass "
              "on the pristine workspace")
        return results

    from .agent_main import MAX_SEQ_LEN
    from .main import build_model

    model, tok = build_model(args.model, args.checkpoint_path, MAX_SEQ_LEN, False,
                             args.impl, args.device)
    gen = GenerationSession(model, tok)
    report = evaluate_task(
        package, lambda messages: gen(messages),
        limits=AgentLimits(max_steps=args.max_steps),
    )
    print(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()

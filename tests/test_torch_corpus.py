"""The tokenizer corpus of the port's real checkpoints (tests/torch_port.py
real_checkpoint) is frozen: the staged build root holds the build script
and the script's corpus with its root files limited to FROZEN_ROOT_MD, so
an edit to README.md, ROADMAP.md, CHANGES.md, PERF.md or any other root
markdown file outside that list leaves the build digest, hence the
tokenizer and the prompt ids, as they were, while an edit to any file the
corpus keeps changes it."""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from .torch_port import (BUILD_SCRIPT, FROZEN_ROOT_MD, REPO, _build_digest, frozen_corpus,
                         stage_build_root)

DOCUMENTS = ["README.md", "ROADMAP.md", "CHANGES.md", "PERF.md", "NOTES.md"]

FROZEN = ["SURVEY.md", "docs/guide.md", "tiny_llm_tpu/ops/x.py", "scripts/tool.py",
          "scripts/make_real_checkpoint.py"]


def _fake_repo(root: Path) -> Path:
    for rel in [*DOCUMENTS, *FROZEN, "tiny_llm_tpu_torch/y.py", "tests/z.py"]:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(f"text of {rel}\n")
    shutil.copyfile(BUILD_SCRIPT, root / "scripts" / "make_real_checkpoint.py")
    return root


def _digest_after_edit(tmp_path: Path, rel: str | None) -> str:
    repo = _fake_repo(tmp_path / "repo")
    if rel is not None:
        with open(repo / rel, "a") as f:
            f.write("an edit\n")
    return _build_digest(stage_build_root(tmp_path / "staged", repo=repo))


def test_staged_root_holds_the_script_and_the_frozen_corpus(tmp_path):
    repo = _fake_repo(tmp_path / "repo")
    staged = stage_build_root(tmp_path / "staged", repo=repo)
    held = sorted(str(p.relative_to(staged)) for p in staged.rglob("*") if p.is_file())
    assert held == sorted(FROZEN)
    assert frozen_corpus(repo) == sorted(FROZEN)


@pytest.mark.parametrize("rel", DOCUMENTS)
def test_digest_ignores_the_documents(tmp_path, rel):
    assert _digest_after_edit(tmp_path / "a", rel) == _digest_after_edit(tmp_path / "b", None)


@pytest.mark.parametrize("rel", FROZEN)
def test_digest_follows_the_frozen_corpus(tmp_path, rel):
    assert _digest_after_edit(tmp_path / "a", rel) != _digest_after_edit(tmp_path / "b", None)


def test_repo_corpus_leaves_out_the_documents():
    corpus = frozen_corpus(REPO)
    assert {r for r in corpus if "/" not in r} <= set(FROZEN_ROOT_MD)
    assert not set(DOCUMENTS) & set(corpus)
    assert {"SURVEY.md", "PAPER.md"} <= set(corpus)
    assert {"docs/agent.md", "scripts/make_real_checkpoint.py",
            "tiny_llm_tpu/agent/generation.py"} <= set(corpus)
    assert not any(r.startswith(("tiny_llm_tpu_torch/", "tests/")) for r in corpus)

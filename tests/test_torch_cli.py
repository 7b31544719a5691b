"""The port's CLIs in-process on the CPU: tiny_llm_tpu_torch.main (cached,
no-cache, paged and speculative generation) and tiny_llm_tpu_torch.batch_main
(paged and dense serving), on the tiny real checkpoint."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from tiny_llm_tpu_torch import batch_main, main  # noqa: E402

from .torch_port import real_checkpoint, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def ckpt() -> list[str]:
    return ["--device", "cpu", "--checkpoint-path", real_checkpoint("qwen3-tiny-real")]


def test_main_speculative_equals_cached_greedy(ckpt, capsys):
    args = [*ckpt, "--max-tokens", "4", "--prompt", "Hello there"]
    greedy = main.main(args)
    spec = main.main([*args, "--draft-checkpoint-path", ckpt[-1], "--no-spec-guard"])
    assert spec == greedy
    assert main.main([*args, "--no-cache"]) == greedy
    assert main.main([*args, "--paged"]) == greedy
    assert capsys.readouterr().out.rstrip().endswith(greedy.rstrip())


def test_main_rejects_bad_flags(ckpt):
    with pytest.raises(SystemExit):
        main.main([*ckpt, "--impl", "pallas"])
    with pytest.raises(SystemExit):
        main.main(["--device", "tpu"])


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense"])
def test_batch_main_serves_every_prompt(ckpt, tmp_path, capsys, dense):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("Why is the sky blue?\n\nWhat is 17 * 23?\nName a color.\n")
    results = batch_main.main([*ckpt, "--prompts-file", str(prompts), "--max-seq-len", "128",
                               "--max-output-tokens", "4", "--batch-size", "2",
                               *(["--dense"] if dense else [])])
    assert sorted(i for i, _ in results) == [0, 1, 2]
    out = capsys.readouterr().out
    assert "-- 3 requests" in out and "tok/s" in out

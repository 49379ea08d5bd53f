"""The PyTorch/CUDA port's examples (``examples/torch_*.py``), each run
once as a user runs it, at ``--device cpu`` (the kernels' plain
versions), in this process (``runpy``, its own ``sys.argv``); each
asserts its own claims, must end without error (a ``SystemExit`` of 0
where it exits) and print its last line as below (the training example
at 4 steps)."""

import os
import runpy
import sys

import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST = {
    "torch_quickstart": "   with injected layer fault: detected = True",
    "torch_abft_kernels_demo": "OK on cpu",
    "torch_intensity_report": "(available archs: ",
    "torch_serve_with_faults": "OK on cpu: soft error detected by ABFT",
    "torch_train_lm": '{"device": "cpu", ',
}
# the training example at a shorter run than its default 30 steps
ARGS = {"torch_train_lm": ("--arch", "llama3.2-1b", "--scale", "smoke",
                           "--steps", "4", "--batch", "2", "--seq", "32",
                           "--ckpt-every", "2")}


@pytest.mark.parametrize("name", sorted(LAST))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    extra = ARGS.get(name, ())
    if extra:
        extra += ("--ckpt-dir", str(tmp_path))
    monkeypatch.setattr(sys, "argv", [path, *extra, "--device", "cpu"])
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e.code
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith(LAST[name]), last

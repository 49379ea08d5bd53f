"""End-to-end training example of the PyTorch/CUDA port (port of
``examples/train_lm.py``): a llama-family model trained with the
production stack — ABFT-protected forward (K1 on the card), AdamW,
checkpointing, deterministic data, detect->retry recovery.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]

Real scale on the card (the ~100M config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --scale 100m --steps 300 --batch 32 --seq 1024 --abft auto

Without arguments it trains the scaled-down config for 30 steps on the
card; other flags go to ``repro_torch.launch.train`` as given.
"""

import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not argv or argv in (["--device", "cpu"], ["--device", "cuda"]):
        with tempfile.TemporaryDirectory() as ckpt:
            raise SystemExit(main([
                "--arch", "llama3.2-1b", "--scale", "smoke",
                "--steps", "30", "--batch", "4", "--seq", "64",
                "--lr", "3e-3", "--abft", "auto", "--ckpt-every", "10",
                "--ckpt-dir", ckpt, *argv]))
    raise SystemExit(main(argv))

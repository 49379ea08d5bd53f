"""Kernel-level demo of the PyTorch/CUDA port: the two fused-ABFT kernels
(port of ``examples/abft_kernels_demo.py``).

1. abft_matmul (K1) — the paper's block-level scheme: checksums computed
   on the tiles the kernel already holds, per-row fault location.
2. flash_attention (K2) — ABFT fused into both attention GEMMs, the
   checksum invariant carried through the online-softmax rescaling.

  PYTHONPATH=src python examples/torch_abft_kernels_demo.py [--device cpu]

On the card the hand-written CUDA kernels run; ``--device cpu`` takes
their plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.faults import FaultSpec
from repro_torch.kernels.flash_ops import flash_attention
from repro_torch.kernels.ops import abft_matmul
from repro_torch.serve.executor import resolve_device, strict_f32

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)
strict_f32(dev)
rng = np.random.default_rng(0)


def tensor(*shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev)


# ---- 1. fused-ABFT matmul ------------------------------------------------
x, w = tensor(256, 512), tensor(512, 256)

y, chk = abft_matmul(x, w, mode="1s", out_dtype=torch.float32)
print(f"matmul clean:     flag={bool(chk.flag)}  "
      f"max residual/threshold="
      f"{float(torch.max(chk.residual / chk.threshold)):.2e}")

y, chk = abft_matmul(x, w, mode="1s", out_dtype=torch.float32,
                     fault=FaultSpec.bitflip(row=100, col=42, bit=28))
res = chk.residual.cpu().numpy()    # (gm, gn, bm): locates the faulty row
gm, gn, bm = res.shape
hot = np.unravel_index(np.argmax(res), res.shape)
print(f"matmul bit-flip:  flag={bool(chk.flag)}  "
      f"located row={hot[0] * bm + hot[2]} (injected row=100)")
assert bool(chk.flag) and hot[0] * bm + hot[2] == 100

# ---- 2. fused-ABFT flash attention ----------------------------------------
q, k, v = (tensor(1, 128, 4, 32) for _ in range(3))

o, chk = flash_attention(q, k, v, causal=True, bq=32, bk=32)
print(f"attention clean:  flag={bool(chk.flag)}  out={tuple(o.shape)}")
assert not bool(chk.flag)

o, chk = flash_attention(q, k, v, causal=True, bq=32, bk=32,
                         fault=FaultSpec.value(row=7, col=3, delta=40.0))
print(f"attention fault:  flag={bool(chk.flag)} "
      "(detected through the online-softmax rescaling)")
assert bool(chk.flag)
print(f"OK on {dev.type}"
      + (f" ({torch.cuda.get_device_name(0)})" if dev.type == "cuda" else ""))

"""Serving example of the PyTorch/CUDA port (port of
``examples/serve_with_faults.py``): continuous-batched generation with a
soft error injected mid-decode, detected by ABFT and recovered by
recompute; the output stream is verified identical to a clean run.

The requests have different prompt lengths and share two slots: the
engine's per-slot cursor keeps every request's KV rows isolated, and each
recovered stream also matches the request served alone.

  PYTHONPATH=src python examples/torch_serve_with_faults.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import ModelFault
from repro_torch.models.model import Model
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.executor import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = scaled_down(get_config("qwen3-14b"))
model = Model(cfg)
params = model.init_params(0, dtype=torch.float32, device=dev)
abft = ABFTConfig()
policy = RecoveryPolicy(max_retries=1, evict_on_hard_fault=True)


def make_requests():
    return [
        Request(uid=i, prompt=np.arange(1, 9 + i, dtype=np.int32),
                max_new_tokens=6)
        for i in range(3)
    ]


def make_engine():
    return ServeEngine(model, params, slots=2, max_len=64, abft=abft,
                       dtype=torch.float32, policy=policy, device=dev)


# clean run
clean = make_engine().run(make_requests())

# each request served alone must match its continuous-batched stream
for ref in make_requests():
    solo = make_engine().run([ref])
    assert solo[ref.uid] == clean[ref.uid], (
        f"mixed-length batching diverged from solo decode for {ref.uid}")

# faulty run: corrupt layer 1's attention output GEMM at decode step 2
fault = ModelFault.at(1, "attn_out", FaultSpec.value(0, 5, 5e4))
eng = make_engine()
faulty = eng.run(make_requests(), fault_at=(2, fault))

print(f"requests served:   {len(faulty)}")
print(f"faults detected:   {eng.stats.faults_detected}")
print(f"retries:           {eng.stats.retries}")
print(f"hard faults:       {eng.stats.hard_faults}")
match = all(clean[k] == faulty[k] for k in clean)
print(f"recovered outputs match clean run: {match}")
assert match and eng.stats.faults_detected >= 1
print(f"OK on {dev.type}: soft error detected by ABFT and recovered "
      "transparently, with per-slot cursors keeping mixed-length requests "
      "isolated.")

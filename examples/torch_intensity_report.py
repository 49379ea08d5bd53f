"""Pre-deployment intensity report of the PyTorch/CUDA port (port of
``examples/intensity_report.py``): compile the architecture's
ProtectionPlan for a serving shape on the H100 and print, per GEMM site,
the arithmetic intensity, the bound regime and the scheme the policy
selected, plus the roofline-autotuned chunked-prefill budget.

  PYTHONPATH=src python examples/torch_intensity_report.py [arch]
      [n_tokens] [--scale smoke] [--plan-out plan.json] [--device cpu]

The plan is host logic; ``--device`` names where the K1 check of one
GEMM at the first site's decode shape runs after the report (the card
unless ``cpu``).
"""

import argparse

import torch

from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.hardware import NVIDIA_H100_SXM
from repro_torch.core.policy import IntensityGuidedPolicy, ProtectionPlan
from repro_torch.kernels.ops import abft_matmul
from repro_torch.models.counting import aggregate_ai
from repro_torch.serve.executor import resolve_device, strict_f32

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="deepseek-v3-671b",
                choices=ALL_ARCHS)
ap.add_argument("n_tokens", nargs="?", type=int, default=128,
                help="tokens per serving step (decode batch)")
ap.add_argument("--scale", choices=["full", "smoke"], default="full",
                help="smoke: scaled-down config")
ap.add_argument("--plan-out", default=None,
                help="write the compiled ProtectionPlan JSON here")
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)
strict_f32(dev)

cfg = get_config(args.arch)
if args.scale == "smoke":
    cfg = scaled_down(cfg)

plan = ProtectionPlan.for_model(
    cfg, hw=NVIDIA_H100_SXM, policy=IntensityGuidedPolicy(),
    phase="serve", n_tokens=args.n_tokens)

print(f"arch={args.arch} ({plan.model})  tokens-per-step={args.n_tokens}  "
      f"device={plan.hardware.name} (CMR={plan.hardware.cmr:.0f})")
print(f"aggregate AI: {aggregate_ai(cfg, args.n_tokens):.1f}")
budget = plan.tune_chunk_budget(lo=8, hi=32768)
print(f"auto chunk budget: {budget} tokens "
      f"(mixed-step AI {plan.step_intensity(budget):.1f})\n")
print(f"{'site':18s} {'m':>9s} {'k':>7s} {'n':>7s} {'count':>6s} "
      f"{'AI':>9s} {'bound':>10s} {'first':>6s}  scheme")
rows = plan.report_rows()
for row in rows:
    print(f"{row['layer']:18s} {row['m']:>9d} {row['k']:>7d} "
          f"{row['n']:>7d} {row['count']:>6d} {row['ai']:>9.1f} "
          f"{row['bound']:>10s} {str(row['first']):>6s}  {row['scheme']}")

if args.plan_out:
    with open(args.plan_out, "w") as fh:
        fh.write(plan.to_json())
    print(f"\nwrote plan artifact -> {args.plan_out}")

# one GEMM of the first site at its decode shape through K1 (its plain
# version on the CPU), to show the plan's shapes run where it was made for
r = rows[0]
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((r["m"], r["k"]), generator=gen, device=dev).bfloat16()
w = torch.randn((r["k"], r["n"]), generator=gen, device=dev).bfloat16()
y, chk = abft_matmul(x, w, mode="1s")
print(f"\nK1 at {r['layer']} ({r['m']} x {r['k']} x {r['n']}) on {dev.type}: "
      f"flag={bool(chk.flag)}")
assert not bool(chk.flag)
print("\n(available archs: " + ", ".join(ALL_ARCHS) + ")")

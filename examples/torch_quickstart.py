"""Quickstart of the PyTorch/CUDA port (port of ``examples/quickstart.py``):
ABFT-protected matmuls, then the policy API, the coverage audit, the
telemetry stack, per-shard plans, a fault campaign with adaptive
protection, speculative decoding that flips the scheme, and a protected
model forward with fault injection and detection.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` (the kernels' plain versions).
"""

import argparse

import numpy as np
import torch

from repro_torch.core.faults import FaultSpec
from repro_torch.core.intensity import GemmDims
from repro_torch.core.protected import ABFTConfig, protected_matmul
from repro_torch.core.selector import selection_report
from repro_torch.serve.executor import resolve_device, strict_f32

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)
strict_f32(dev)

# ---------------------------------------------------------------- 1. one GEMM
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((64, 512))).to(dev, torch.bfloat16)
w = torch.from_numpy(rng.standard_normal((512, 1024))).to(dev, torch.bfloat16)

y, check = protected_matmul(x, w)          # scheme auto-selected by AI vs CMR
print(f"1) clean GEMM on {dev.type}: fault detected = {bool(check.flag)}")

# inject a soft error into the GEMM output -> detected.  On the fused
# block path the bit indexes the f32 accumulator (bits 23-30 = exponent);
# on the global path it indexes the output dtype.
y, check = protected_matmul(x, w, fault=FaultSpec.bitflip(row=3, col=17,
                                                          bit=28))
print(f"   bit-flipped GEMM: fault detected = {bool(check.flag)}")
assert bool(check.flag)

# ---------------------------------------------------------------- 2. selection
print("\n2) intensity-guided selection on the H100 (paper §5.3):")
report = selection_report({
    "decode mlp (thin)": GemmDims(m=8, k=4096, n=14336),
    "prefill mlp (fat)": GemmDims(m=131072, k=4096, n=14336),
})
for r in report:
    print(f"   {r['layer']:20s} AI={r['ai']:9.1f} {r['bound']:9s} "
          f"-> {r['scheme']}")

# ------------------------------------------------------- 2b. the policy API
from repro_torch.core.hardware import NVIDIA_H100_SXM  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    IntensityGuidedPolicy,
    ProtectionPlan,
    StepShape,
)

plan = ProtectionPlan.build(
    {"decode mlp (thin)": GemmDims(m=8, k=4096, n=14336),
     "prefill mlp (fat)": GemmDims(m=131072, k=4096, n=14336)},
    hw=NVIDIA_H100_SXM, policy=IntensityGuidedPolicy(),
    step_shape=StepShape(d_model=4096, d_ff=14336))
reloaded = ProtectionPlan.from_json(plan.to_json())
assert [e.selection.scheme_name for e in reloaded.entries] == \
    [e.selection.scheme_name for e in plan.entries]
print(f"\n2b) plan round-trip: {len(plan.entries)} layers, "
      f"decode-step scheme = {plan.for_step(8).scheme_name}")

# ------------------------------------------------- 2c. the coverage auditor
# a plan claims protection; the auditor proves it: run the model's real
# prefill/decode entry points under the op walker, and check each
# FLOP-carrying op sits inside a registered scheme's scope, with the
# plan <-> trace site bijection as a second witness.
# CLI: python -m repro_torch.launch.audit --config llama3.2-1b
from repro_torch.analysis.audit import audit_config  # noqa: E402

rep = audit_config("llama3.2-1b", phase="decode", check_flash=False,
                   device=dev)
assert rep.protected_fraction == 1.0 and rep.crosscheck.bijective
print(f"\n2c) coverage audit: protected={rep.protected_fraction:.2f}; "
      f"{rep.crosscheck.report()}")

# ---------------------------------------------------- 2d. observability
from repro_torch.obs import (  # noqa: E402
    FaultRateMonitor,
    MetricsRegistry,
    Tracer,
)

reg = MetricsRegistry()
detections = reg.counter("abft_faults_detected_total",
                         "ABFT checksum mismatches", labels=("scheme",))
detections.labels(scheme="global").inc()
lat = reg.histogram("serve_step_latency_seconds", "step wall time",
                    buckets=(0.001, 0.01, 0.1))
lat.observe(0.004)

tracer = Tracer()
with tracer.span("decode_step", {"tokens": 8}):
    with tracer.span("abft_check"):
        pass
tracer.instant("scheme_flip", {"scheme": "global", "intensity": 42.0})

monitor = FaultRateMonitor(window=128)
monitor.observe(steps=1, tokens=8, detections=1, retries=1)
print("\n2d) telemetry:")
print("   " + "\n   ".join(reg.render_prometheus().splitlines()[:4]))
print(f"   trace events = {len(tracer.events)}, windowed detection "
      f"rate = {monitor.window_detection_rate:.3f}/step")

# ------------------------------------------- 2e. per-shard plans (mesh)
# tensor parallelism divides each GEMM's N (column-parallel) or K
# (row-parallel) by the mesh width, lowering every shard's arithmetic
# intensity, so the same layer can land on a different scheme once
# sharded.  Plan compilation is host-side: no mesh needed to see it.
from repro_torch.configs import get_config, scaled_down  # noqa: E402
from repro_torch.core.hardware import HardwareSpec  # noqa: E402
from repro_torch.models.layers import LayerCtx, ModelFault  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

cfg = scaled_down(get_config("llama3.2-1b"))
model = Model(cfg)
shard_hw = HardwareSpec(        # CMR between full-width and 4-way-shard AI
    name="shard-flip", peak_flops=2.4e13, vpu_flops=1e11, hbm_bw=1e12,
    ici_bw=1e11, hbm_bytes=1 << 34, vmem_bytes=1 << 24,
    fixed_op_overhead_s=1e-7)
print("\n2e) per-shard protection plans (tensor parallel):")
per_width = {}
for tp in (1, 4):
    p = model.protection_plan(hw=shard_hw, phase="serve", n_tokens=64,
                              model_parallel=tp)
    per_width[tp] = {r["layer"]: r for r in p.report_rows()}
for layer, row in per_width[1].items():
    r4 = per_width[4][layer]
    mark = "  <- scheme flips" if row["scheme"] != r4["scheme"] else ""
    print(f"   {layer:9s} TP=1 ai={row['ai']:5.1f} {row['scheme']:8s} | "
          f"TP=4 ai={r4['ai']:5.1f} {r4['scheme']:8s}{mark}")
assert any(per_width[1][la]["scheme"] != per_width[4][la]["scheme"]
           for la in per_width[1])

# ------------------------------- 2f. fault campaigns + adaptive protection
# a seeded FaultModel Bernoulli-injects transient faults every engine
# step, the engine's shadow streams classify each one as corrected /
# uncorrected / SDC / masked, and an ErrorAdaptivePolicy consumes the
# observed fault rate to escalate protection at runtime.
from repro_torch.core.faults import FaultModel  # noqa: E402
from repro_torch.core.policy import ErrorAdaptivePolicy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

print("\n2f) fault campaign + error-rate-adaptive escalation:")
qparams = model.init_params(0, dtype=torch.float32, device=dev)


def qreqs():
    return [Request(uid=i, prompt=np.arange(1, 6 + i, dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]


adaptive = ErrorAdaptivePolicy(IntensityGuidedPolicy(),
                               detection_threshold=0.05)
campaign = FaultModel(transient_rate=0.5, seed=1, layers=cfg.n_layers,
                      dtype=torch.float32, magnitude=1e4)
clean_eng = ServeEngine(model, qparams, slots=2, max_len=64,
                        abft=ABFTConfig.from_policy(IntensityGuidedPolicy()),
                        dtype=torch.float32, device=dev)
clean_streams = clean_eng.run(qreqs())
eng = ServeEngine(model, qparams, slots=2, max_len=64,
                  abft=ABFTConfig.from_policy(adaptive),
                  dtype=torch.float32, fault_model=campaign, device=dev)
streams = eng.run(qreqs())
s = eng.stats
print(f"   injected={s.faults_injected} corrected={s.faults_corrected} "
      f"uncorrected={s.faults_uncorrected} sdc={s.sdc_faults} "
      f"masked={s.masked_faults}")
print(f"   escalations={s.protection_escalations} "
      f"(level {eng.protection_level}: the observed detection rate "
      f"crossed {adaptive.detection_threshold})")
for entry in s.injection_log[:3]:
    print(f"   step {entry['engine_step']:2d} {entry['phase']:8s} "
          f"L{entry['layer']} {entry['site']:8s} -> {entry['outcome']}")
assert s.faults_injected > 0 and s.sdc_faults == 0
assert s.protection_escalations >= 1
assert streams == clean_streams          # recovery stayed transparent

# ----------------------------- 2g. speculative decoding flips the scheme
# speculation scores K+1 positions a slot in one verify call, so a decode
# step's token count grows from `slots` to sum(k_i + 1).  On hardware
# whose scheme crossover sits between the two, speculation alone flips
# the per-step scheme.  Greedy streams stay identical to the unsped run.
flip_hw = HardwareSpec(
    name="flip", peak_flops=1e10, vpu_flops=2.6e8, hbm_bw=1e9,
    ici_bw=1e9, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
    fixed_op_overhead_s=1e-6)


def spec_reqs():
    return [Request(uid=i, prompt=np.tile(np.arange(3, 7 + i % 2,
                                                    dtype=np.int32),
                                          16)[:21 + 2 * i],
                    max_new_tokens=14 + i % 3) for i in range(4)]


spec_abft = ABFTConfig(hardware=flip_hw)
print("\n2g) speculative decoding (K-sweep on scheme-flip hardware):")
base_eng = ServeEngine(model, qparams, slots=4, max_len=64,
                       abft=spec_abft, dtype=torch.float32, device=dev)
base = base_eng.run(spec_reqs())
for k in (1, 4):
    seng = ServeEngine(model, qparams, slots=4, max_len=64,
                       abft=spec_abft, dtype=torch.float32, device=dev,
                       spec_decode="ngram", draft_len=k)
    sout = seng.run(spec_reqs())
    assert sout == base                  # identical greedy streams
    st = seng.stats
    schemes = sorted({e["scheme"] for e in st.selection_trace
                      if e["decode"] and not e["prefill"]})
    rate = st.draft_accepted / max(st.draft_proposed, 1)
    print(f"   K={k}: accept={rate:.2f} verify-window schemes={schemes}")
    if k == 4:
        assert "global" in schemes       # the K=4 window crossed the CMR
print(f"   plan.for_step:  4 tokens -> "
      f"{base_eng.plan.for_step(4).scheme_name},  20 tokens -> "
      f"{base_eng.plan.for_step(20).scheme_name}")

# ---------------------------------------------------------------- 3. a model
ctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy()))
batch = {"tokens": torch.ones((2, 16), dtype=torch.long, device=dev)}

out = model.forward(qparams, batch, ctx, device=dev)
print(f"\n3) model forward on {dev.type}: logits {tuple(out.logits.shape)}, "
      f"fault detected = {bool(out.flag)}")

bad_ctx = LayerCtx(
    abft=ctx.abft,
    fault=ModelFault.at(1, "mlp_down", FaultSpec.value(0, 3, 1e4)))
out = model.forward(qparams, batch, bad_ctx, device=dev)
print(f"   with injected layer fault: detected = {bool(out.flag)}")
assert bool(out.flag)

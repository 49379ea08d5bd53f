"""Import isolation of the PyTorch port: no ``repro_torch`` module — and
not ``chip_smoke.py`` — imports ``jax`` or the reference package
``repro``.  Checked in a fresh interpreter whose ``sys.meta_path`` refuses
both."""

import json
import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = r"""
import importlib, importlib.abc, json, pkgutil, sys
sys.path[:0] = [ROOT, ROOT + "/src"]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"forbidden import {name!r}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
mods = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def _expected_modules():
    src = os.path.join(ROOT, "src", "repro_torch")
    names = {"repro_torch"}
    for dirpath, _, files in os.walk(src):
        rel = os.path.relpath(dirpath, os.path.join(ROOT, "src"))
        if "build" in rel.split(os.sep) or "csrc" in rel.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                mod = os.path.join(rel, f[:-3]).replace(os.sep, ".")
                names.add(mod[: -len(".__init__")]
                          if mod.endswith(".__init__") else mod)
    return names


def test_port_imports_neither_jax_nor_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _GUARD],
        capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert set(out["modules"]) == _expected_modules()


def test_module_walk_finds_the_slice():
    mods = _expected_modules()
    for name in ("repro_torch.kernels.ops", "repro_torch.kernels.ref",
                 "repro_torch.kernels.flash_ops",
                 "repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.serve.spec_decode",
                 "repro_torch.models.moe", "repro_torch.models.mamba",
                 "repro_torch.train.trainer", "repro_torch.launch.train",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.data.pipeline", "repro_torch.runtime.elastic",
                 "repro_torch.obs", "repro_torch.obs.metrics",
                 "repro_torch.obs.trace", "repro_torch.obs.faultrate",
                 "repro_torch.obs.telemetry", "repro_torch.core.selector",
                 "repro_torch.core.profiler", "repro_torch.models.counting",
                 "repro_torch.configs.qwen3_14b",
                 "repro_torch.configs.stablelm_1_6b",
                 "repro_torch.configs.qwen1_5_32b",
                 "repro_torch.configs.qwen2_moe_a2_7b",
                 "repro_torch.configs.deepseek_v3_671b",
                 "repro_torch.configs.jamba_v0_1_52b",
                 "repro_torch.configs.mamba2_1_3b",
                 "repro_torch.configs.whisper_tiny",
                 "repro_torch.configs.llama3_2_vision_11b",
                 "repro_torch.analysis", "repro_torch.analysis.markers",
                 "repro_torch.analysis.op_walk",
                 "repro_torch.analysis.crosscheck",
                 "repro_torch.analysis.audit", "repro_torch.launch.audit"):
        assert name in mods
    assert pkgutil  # the subprocess walks packages the same way

"""The port imports neither JAX nor anything of the JAX package ``repro``:
every module of ``repro_torch`` (the autotuner, the break-even model, the
epoch telemetry, ``obs``, the plan store with their CLIs, and the
training modules included: ``train``, ``data``, ``ckpt``, ``runtime`` and
the train launcher; the dense FFN, Ulysses, the flash attention path, the
pod-aware collectives and the five configs of the attention-only
families; the state-space, audio and vision families' ``scan_utils``,
``mamba``, ``xlstm``, ``whisper``, ``vlm`` and their four configs; the
resilience layer's ``chaos``, ``leader`` and ``replan``; the roofline's
``hw``, ``analyze`` and ``trace``, the dry run and the hillclimb; the
ranks in processes: ``kernels.rma_signal``, the process mesh, the shared
windows and ``testing.dist_cases``, the twin of the JAX package's dist
cases), the port's examples and ``chip_smoke.py``."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import sys
import pkgutil
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    __import__(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "repro_torch.core.plan" in mods and "repro_torch.kernels.a2a_lock" in mods
assert "repro_torch.kernels.a2a_hier" in mods and "repro_torch.kernels.ops" in mods
for m in ("repro_torch.models.moe", "repro_torch.kernels.gather_matmul",
          "repro_torch.serve.engine", "repro_torch.launch.serve",
          "repro_torch.core.patterns", "repro_torch.parallel.wirecodec",
          "repro_torch.core.variants", "repro_torch.core.api",
          "repro_torch.core.autotune", "repro_torch.core.breakeven",
          "repro_torch.core._exec_stats", "repro_torch.obs.spans",
          "repro_torch.obs.trace_export", "repro_torch.obs.breakeven_check",
          "repro_torch.obs.metrics", "repro_torch.obs.__main__",
          "repro_torch._version", "repro_torch.planstore.schema",
          "repro_torch.planstore.codec", "repro_torch.planstore.backend",
          "repro_torch.planstore.store", "repro_torch.planstore.prewarm",
          "repro_torch.planstore.__main__", "repro_torch.train.schedule",
          "repro_torch.train.optimizer", "repro_torch.train.grad",
          "repro_torch.train.loop", "repro_torch.parallel.compression",
          "repro_torch.data.synthetic", "repro_torch.data.pipeline",
          "repro_torch.ckpt.manager", "repro_torch.ckpt.reshard",
          "repro_torch.runtime.fault", "repro_torch.runtime.straggler",
          "repro_torch.runtime.chaos", "repro_torch.runtime.leader",
          "repro_torch.runtime.replan",
          "repro_torch.launch.train", "repro_torch._tree",
          "repro_torch.models.mlp", "repro_torch.models.ulysses",
          "repro_torch.models.attention", "repro_torch.parallel.collectives",
          "repro_torch.configs.moonshot_v1_16b_a3b",
          "repro_torch.configs.olmo_1b", "repro_torch.configs.minicpm_2b",
          "repro_torch.configs.nemotron_4_15b",
          "repro_torch.configs.deepseek_67b", "repro_torch.models.scan_utils",
          "repro_torch.models.mamba", "repro_torch.models.xlstm",
          "repro_torch.models.whisper", "repro_torch.models.vlm",
          "repro_torch.configs.jamba_v01_52b", "repro_torch.configs.xlstm_125m",
          "repro_torch.configs.whisper_base",
          "repro_torch.configs.internvl2_26b", "repro_torch.roofline.hw",
          "repro_torch.roofline.analyze", "repro_torch.roofline.trace",
          "repro_torch.launch.dryrun", "repro_torch.launch.perf_hillclimb",
          "repro_torch.launch.mesh", "repro_torch.kernels.rma_signal",
          "repro_torch.core.window", "repro_torch.core.baseline",
          "repro_torch.testing.dist_cases", "repro_torch.testing.patterns"):
    assert m in mods and m in sys.modules, m
import importlib.util
for name in ("quickstart_torch", "serve_batched_torch", "train_moe_ep_torch",
             "persistent_alltoallv_torch"):
    spec = importlib.util.spec_from_file_location(name, f"examples/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("GUARD_OK", len(mods))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", GUARD], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "GUARD_OK" in r.stdout, r.stderr[-3000:]

"""The port never imports JAX or the JAX package.

In a fresh interpreter, a ``sys.meta_path`` finder refuses ``jax``,
``jaxlib`` and ``repro`` (each name and its submodules, not
``repro_torch``); then every module under ``src/repro_torch/`` and
``chip_smoke.py`` (imported, not run) must import.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

GUARD = r"""
import importlib, importlib.abc, importlib.util, sys

BANNED = ("jax", "jaxlib", "repro")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name!r}")
        return None


sys.meta_path.insert(0, Refuse())
for name in sys.argv[2:]:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print("imported", len(sys.argv) - 2, "modules")
"""


def run_guarded(*modules):
    return subprocess.run(
        [sys.executable, "-c", GUARD, str(ROOT / "chip_smoke.py"), *modules],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_and_smoke_import_without_jax_or_reference():
    mods = list(port_modules())
    for name in ("apps.kv_serve", "serve.access_service", "serve.traffic",
                 "serve.kv_driver", "serve.kv_cache", "serve.serve",
                 "testing.fuzzer", "configs.base", "configs.qwen3_0_6b",
                 "configs.dbrx_132b", "models.layers", "models.embedding",
                 "models.moe", "models.remat", "models.transformer",
                 "models.model", "models.mamba", "models.hybrid",
                 "models.rwkv", "models.rwkv_lm", "models.encdec", "testing.oracle", "testing.conformance",
                 "testing.harness", "testing.streams", "analysis.program",
                 "distributed", "distributed.mesh", "distributed.exchange",
                 "distributed.engine", "distributed.spawn", "core.tree", "optim.adamw",
                 "optim.compress", "optim.schedules", "data.batches",
                 "data.pipeline", "train.trainer", "train.checkpoint",
                 "train.elastic", "launch.mesh", "launch.train",
                 "launch.dryrun", "roofline.analysis"):
        assert f"repro_torch.{name}" in mods
    proc = run_guarded(*mods)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)} modules" in proc.stdout


def test_guard_refuses_the_reference():
    proc = run_guarded("repro_torch.core", "repro.core")
    assert proc.returncode != 0
    assert "the port imported 'repro'" in proc.stderr

"""Nothing that the benchmark runs imports JAX or the JAX package:
every module of `vio_bench` and the port imports with them blocked,
top-level names compared whole, so that `xrslam_tpu_torch` passes."""

import os
import subprocess
import sys

from vio_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKED = r'''
import importlib.abc, importlib.util, os, pkgutil, sys
FORBIDDEN = {"jax", "jaxlib", "flax", "xrslam_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import vio_bench
mods = ["vio_bench." + m.name for m in pkgutil.iter_modules(vio_bench.__path__)]
mods += ["xrslam_tpu_torch.api", "xrslam_tpu_torch.core.sliding_window",
         "xrslam_tpu_torch.estimation.solver", "xrslam_tpu_torch.estimation.gram",
         "xrslam_tpu_torch.frontend.klt", "xrslam_tpu_torch.ransac.pnp"]
for m in mods:
    importlib.import_module(m)
for f in os.listdir(os.path.join(vio_bench.__path__[0], "metrics")):
    if f.endswith(".py"):
        spec = importlib.util.spec_from_file_location("m", os.path.join(vio_bench.__path__[0], "metrics", f))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
print("loaded", len(mods), "bad", bad)
assert not bad, bad
'''


def test_no_module_imports_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "bad []" in out.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "xrslam_tpu_torch_fake_probe", sys)
    assert "xrslam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]

"""The port stands alone: it imports neither jax nor the JAX package.

A subprocess whose `sys.modules` blocks `jax`, `jaxlib` and
`xrslam_tpu` imports every module of `xrslam_tpu_torch` and runs a
short port-only CPU drive (the machine with the card has no jax). A
static scan of the sources checks the same for modules no test
imports.
"""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "xrslam_tpu_torch")
BLOCKED = ("jax", "jaxlib", "xrslam_tpu")


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")] if mod.endswith("__init__") else mod)
    return sorted(out)


def test_sources_import_no_jax():
    for mod in _modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in BLOCKED, f"{mod} imports {n}"


def test_port_runs_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        for mod in {_modules()!r}:
            importlib.import_module(mod)
        import torch
        from xrslam_tpu_torch import api
        from xrslam_tpu_torch.tools.make_dataset import render_sequence, run_sequence
        seq = render_sequence(n_frames=4)
        slam = api.XRSLAM(config=seq["config"], device="cpu")
        run_sequence(api, slam, seq)
        assert len(slam.pipeline.tracker_map.frames) == 4
        n = slam.pipeline.tracker_map.frames[-1].n_keypoints()
        assert n > 20, n
        assert not any(m == "jax" or m.startswith(("jax.", "xrslam_tpu."))
                       or m == "xrslam_tpu" for m in sys.modules
                       if sys.modules[m] is not None)
        print("OK", n)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_host_runtime_capi_and_batch_entry_points_with_jax_blocked():
    """The native host runtime, the C ABI host module, the ROS node, the
    multi-sequence driver, `solve_chained_batch` and the split subframe
    step import and exist with jax and the JAX package blocked; the C
    ABI shim's source drives the port's host module only."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from xrslam_tpu_torch import capi_host, native
        from xrslam_tpu_torch.core.sliding_window import SlidingWindowTracker
        from xrslam_tpu_torch.estimation import solver
        from xrslam_tpu_torch.tools import multiseq, ros_node
        assert callable(solver.solve_chained_batch)
        assert callable(SlidingWindowTracker.prepare_fused_subframe)
        assert callable(SlidingWindowTracker.finish_fused_subframe)
        assert callable(multiseq.ChainedSolveBroker) and callable(ros_node.RosVioNode)
        assert callable(capi_host.create) and native.available()
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout
    src = open(os.path.join(PKG, "native", "xr_capi.cpp")).read()
    assert 'PyImport_ImportModule("xrslam_tpu_torch.capi_host")' in src
    assert "xrslam_tpu." not in src


def test_sharded_solve_and_scaling_with_jax_blocked():
    """The sharded solve's modules, `run_scaling`, the Gram form and the
    window fixtures import and exist with jax and the JAX package
    blocked, and a one-rank model-mode `run_scaling` runs on the CPU."""
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        from xrslam_tpu_torch import parallel
        from xrslam_tpu_torch.estimation import gram
        from xrslam_tpu_torch.io import synthetic
        from xrslam_tpu_torch.parallel import mesh, sharded
        from xrslam_tpu_torch.tools import run_scaling
        assert parallel.mesh is mesh and parallel.sharded is sharded
        for fn in (mesh.make_mesh, mesh.initialize_distributed, mesh.run_ranks,
                   sharded.shard_window, sharded.gather_window,
                   sharded.solve_window_sharded, sharded.solve_batch_sharded,
                   gram.reproj_gram_matmul, synthetic.circle_scene,
                   synthetic.window_problem, synthetic.demo_window_problem):
            assert callable(fn)
        res = run_scaling.main(["--device", "cpu", "--devices", "1", "--modes", "model",
                                "--frames", "4", "--landmarks", "32", "--iters", "1",
                                "--reps", "1"])
        assert res["model"][0]["cost_finite"]
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout

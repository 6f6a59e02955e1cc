"""The port's three A/B tools (`xrslam_tpu_torch/tools/ab_assemble.py`,
`ab_lk_backend.py`, `ab_klt_precision.py`) on the CPU at a small size:
`ab_assemble --K 4 --L 32` and a rendered 160x120 pair (two pyramid
levels above it, 64 GFTT points). Each prints one JSON line with its
keys; the kernel routes are reported as not run on the CPU while the
other routes run and are checked; the plain and Gram-form systems agree
at 1e-9, and the port's `assemble` on the demo window equals the JAX
package's at 1e-9. The card runs of the tools are `chip_smoke.py`'s."""

import json

import jax
import numpy as np
import pytest
import torch

from xrslam_tpu.estimation import solver as jsolver
from xrslam_tpu.io.synthetic import demo_window_problem as jdemo_window_problem
from xrslam_tpu_torch import convert
from xrslam_tpu_torch.estimation import solver
from xrslam_tpu_torch.frontend import klt
from xrslam_tpu_torch.io.synthetic import demo_window_problem
from xrslam_tpu_torch.tools import ab_assemble, ab_klt_precision, ab_lk_backend

NOT_RUN = "not run: cpu"
PAIR = dict(width=160, height=120, focal=130.0, points=64, reps=1, device="cpu", levels=2)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_ab_assemble_line(capsys):
    out = ab_assemble.main(["--K", "4", "--L", "32", "--reps", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    assert set(out) == {"device", "K", "L", "dtype", "reps", "solve_iterations",
                        "reference", "kernel", "plain", "gram_form", "agree"}
    assert out["kernel"] == NOT_RUN and out["agree"]
    for name in ("plain", "gram_form"):
        r = out[name]
        assert set(r) == {"assemble_ms", "solve10_ms", "max_abs_diff_vs_plain",
                          "worst_entry", "agree"}
        assert r["worst_entry"]["excess"] <= 0.0
        assert r["agree"] and r["assemble_ms"] > 0 and r["solve10_ms"] > 0
    assert out["plain"]["max_abs_diff_vs_plain"] == 0.0


def test_ab_assemble_routes_agree_and_match_jax():
    """The swapped-in Gram form against the plain block at rtol/atol
    1e-9, the route restored after the block; the port's assemble
    against the JAX package's on the same demo window at 1e-9."""
    state, data = demo_window_problem(4, 32)
    opts = solver.SolveOptions(iterations=1)
    plain = solver.assemble(state, data, opts)
    with ab_assemble.reproj_route(ab_assemble.gram_form):
        form = solver.assemble(state, data, opts)
    assert ab_assemble.max_rel_excess(form, plain) <= 0.0
    assert solver.gram.reproj_factor_gram is not ab_assemble.gram_form
    # the check's scale: Cauchy-Schwarz over the summed terms, at least
    # |entry|; an off-diagonal entry moved by 1e-6 of its scale fails it
    H = plain[0]
    scales = ab_assemble.entry_scales(plain)
    for x, sc in zip(plain, scales):
        assert bool((sc * (1 + 1e-12) + 1e-300 >= x.abs()).all())
    k = (0, 6, 1, 7)
    moved = H.clone()
    moved[k] += 1e-6 * scales[0][k]
    assert ab_assemble.max_rel_excess((moved, *plain[1:]), plain) > 0.0
    assert ab_assemble.worst_entry((moved, *plain[1:]), plain)["index"] == list(k)
    jst, jdata = jdemo_window_problem(4, 32, jax.numpy.float64)
    ref = jax.jit(jsolver.assemble, static_argnums=2)(jst, jdata, jsolver.SolveOptions(
        iterations=1))
    for n, a, b in zip(["H", "b", "Hll", "Hfl", "bl", "cost"], ref, plain):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9, atol=1e-9, err_msg=n)
    # the tool's window is the JAX fixture
    for a, b in zip(convert.to_numpy(state), convert.to_numpy(convert.to_torch(jst))):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=0,
                                   atol=1e-12)


def test_ab_lk_backend_on_cpu():
    out = ab_lk_backend.run(**PAIR)
    assert set(out) == {"device", "width", "height", "levels", "points", "valid", "reps",
                        "reference", "fused", "chain", "plain", "agree"}
    assert out["fused"] == out["chain"] == NOT_RUN
    assert out["points"] == 64 and out["valid"] > 0
    p = out["plain"]
    assert set(p) == {"ms_per_pair", "tracked", "status_agree", "max_px_vs_plain", "agree"}
    assert p["agree"] and out["agree"] and p["status_agree"] == 1.0 and p["tracked"] > 10


def test_ab_klt_precision_on_cpu():
    out = ab_klt_precision.run(**PAIR)
    assert out["kernel_f32"] == NOT_RUN and out["reference"] == "plain_f64"
    f32, f64 = out["plain_f32"], out["plain_f64"]
    for r in (f32, f64):
        assert set(r) == {"ms_per_pair", "survivors", "survivor_ratio_vs_f64",
                          "common_survivors", "max_px_vs_f64", "agree"}
        assert r["agree"]
    assert out["agree"]
    assert f64["survivors"] > 10 and f64["max_px_vs_f64"] == 0.0
    assert f32["survivors"] > 10 and f32["common_survivors"] > 10
    assert 0.9 <= f32["survivor_ratio_vs_f64"] <= 1.1 and f32["max_px_vs_f64"] < 1e-2


@pytest.mark.parametrize("shift", [0.0, 2e-3], ids=["same", "moved_2e-3px"])
def test_ab_klt_precision_flags_disagreement(monkeypatch, shift):
    """A route whose common survivors move by more than 1e-3 px from
    float64 is flagged, and the line with it."""
    def moved(*args):
        nxt, st = klt.track_keypoints_plain(*args)
        return nxt + shift, st

    monkeypatch.setitem(ab_klt_precision.ROUTES, "plain_f32", (moved, torch.float32))
    out = ab_klt_precision.run(**PAIR)
    assert out["plain_f32"]["agree"] == out["agree"] == (shift == 0.0)
    assert out["plain_f64"]["agree"]

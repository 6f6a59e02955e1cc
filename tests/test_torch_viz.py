"""The port's visualization module (`xrslam_tpu_torch/tools/viz.py`)
against the JAX package's (`tests/test_viz.py`): `draw_overlay` bit-equal
to JAX's on the same inputs (float and uint8 images, points off the
image, default lengths), the trajectory plot, and the overlay writer on
the port's painter tap, which the image tracker publishes on each frame
while the writer is subscribed."""

import numpy as np
import pytest

from xrslam_tpu.tools import viz as jviz
from xrslam_tpu_torch.tools import viz
from xrslam_tpu_torch.utils import inspection


@pytest.mark.parametrize("kind", ["float", "uint8", "no_lengths"])
def test_draw_overlay_matches_jax(kind):
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (60, 80))
    if kind == "uint8":
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    pts = np.concatenate([rng.uniform(-10, 90, (40, 2)), [[10.0, 20.0], [79.6, 59.4]]])
    lengths = None if kind == "no_lengths" else rng.integers(0, 15, len(pts))
    out = viz.draw_overlay(img, pts, lengths)
    ref = jviz.draw_overlay(img, pts, lengths)
    assert out.shape == (60, 80, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_draw_overlay_marks_points():
    img = np.zeros((60, 80), dtype=np.float64)
    pts = np.array([[10.0, 20.0], [70.0, 50.0], [-5.0, 5.0]])  # last OOB
    out = viz.draw_overlay(img, pts, lengths=np.array([1, 12, 3]))
    # short track ring is red-ish, long is green-ish
    assert out[20 - 3, 10, 0] > 200 and out[20 - 3, 10, 1] < 60
    assert out[50 - 3, 70, 1] > 200 and out[50 - 3, 70, 0] < 60


def test_plot_trajectory(tmp_path):
    t = np.linspace(0, 2 * np.pi, 50)
    est = np.stack([np.cos(t), np.sin(t), 0 * t], axis=-1)
    p = tmp_path / "traj.png"
    viz.plot_trajectory(str(p), est, est + 0.01)
    assert p.exists() and p.stat().st_size > 500


def test_overlay_writer_on_tracker_tap(tmp_path):
    """The writer subscribes to the tap the port's KLT tracker publishes:
    three rendered frames through `api.XRSLAM` on the CPU give one
    overlay each; after `close` nothing more is written."""
    from PIL import Image

    from xrslam_tpu_torch import api
    from xrslam_tpu_torch.tools.make_dataset import render_sequence, run_sequence

    seq = render_sequence(n_frames=3)
    w = viz.OverlayWriter(str(tmp_path))
    try:
        assert inspection.inspect_get(inspection.PAINTER_ENABLE)
        slam = api.XRSLAM(config=seq["config"], device="cpu")
        run_sequence(api, slam, seq)
    finally:
        w.close()
    assert not inspection.inspect_get(inspection.PAINTER_ENABLE)
    files = sorted(tmp_path.glob("frame_*.png"))
    assert w.written == len(files) == slam.pipeline.frames_processed == 3
    img = np.asarray(Image.open(files[0]))
    assert img.shape == (240, 320, 3)
    assert (img[..., 0] != img[..., 1]).any()  # coloured rings on gray
    inspection.inspect(inspection.PAINTER_FRAME, {
        "image": np.zeros((40, 40)), "pts": np.array([[5.0, 5.0]]),
        "lengths": np.array([4]), "frame_id": 7, "t": 0.0})
    assert w.written == 3 and not (tmp_path / "frame_000007.png").exists()

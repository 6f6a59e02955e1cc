"""Minimal visualization: keypoint/track overlays + trajectory plots
(port of `xrslam_tpu/tools/viz.py`, host-side numpy and Pillow).

The headless stand-in for the reference's OpenCV painter and liteviz GL
visualizer (reference: xrslam-pc/player/ — OpenCvPainter over the
InspectPainter taps, include/xrslam/inspection.h:41-57): per-frame
overlay PNGs color-coded by track length, and a top-down trajectory
plot (estimate vs ground truth). Pure numpy + PIL — no GL, no OpenCV.

Used by `run_dataset --viz out/`; also importable:

    from xrslam_tpu_torch.tools.viz import OverlayWriter
    w = OverlayWriter("out/")          # subscribes to the painter tap
    ... run the pipeline ...
    w.close()
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils import inspection


def _color_for_length(n: int):
    """Short tracks red → long tracks green (the usual VIO painter
    convention for track confidence)."""
    t = min(max(n - 1, 0), 10) / 10.0
    return (int(255 * (1 - t)), int(255 * t), 40)


def draw_overlay(image: np.ndarray, pts: np.ndarray,
                 lengths: Optional[np.ndarray] = None,
                 radius: int = 3) -> np.ndarray:
    """Render keypoints onto a grayscale image ((H,W) float [0,1] or
    uint8). Returns (H,W,3) uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    H, W = img.shape[:2]
    out = np.stack([img] * 3, axis=-1) if img.ndim == 2 else img.copy()
    if lengths is None:
        lengths = np.ones(len(pts), dtype=int)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    ring = (xx * xx + yy * yy <= radius * radius) & \
           (xx * xx + yy * yy >= (radius - 1) ** 2)
    ry, rx = np.nonzero(ring)
    ry, rx = ry - radius, rx - radius
    for (x, y), n in zip(np.asarray(pts), np.asarray(lengths)):
        cx, cy = int(round(x)), int(round(y))
        if not (0 <= cx < W and 0 <= cy < H):
            continue
        ys = np.clip(cy + ry, 0, H - 1)
        xs = np.clip(cx + rx, 0, W - 1)
        out[ys, xs] = _color_for_length(int(n))
    return out


def plot_trajectory(path: str, est_p: np.ndarray,
                    gt_p: Optional[np.ndarray] = None,
                    size: int = 640, margin: int = 30):
    """Top-down (x,y) trajectory plot PNG: estimate in green, ground
    truth in gray."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size), (18, 18, 22))
    d = ImageDraw.Draw(img)
    all_p = est_p if gt_p is None else np.concatenate([est_p, gt_p])
    if len(all_p) == 0:
        img.save(path)
        return
    lo = all_p[:, :2].min(0)
    hi = all_p[:, :2].max(0)
    span = max(float((hi - lo).max()), 1e-6)

    def to_px(p):
        q = (p[:2] - lo) / span
        return (margin + q[0] * (size - 2 * margin),
                size - margin - q[1] * (size - 2 * margin))

    for ps, color in ((gt_p, (110, 110, 110)), (est_p, (70, 220, 90))):
        if ps is None or len(ps) < 2:
            continue
        d.line([to_px(p) for p in ps], fill=color, width=2)
    d.text((8, 8), "est", fill=(70, 220, 90))
    if gt_p is not None:
        d.text((8, 22), "gt", fill=(110, 110, 110))
    img.save(path)


class OverlayWriter:
    """Subscribes to the painter inspection tap and writes one overlay
    PNG per frame (every `every`-th) into `out_dir`; `written` counts
    them."""

    def __init__(self, out_dir: str, every: int = 1):
        from PIL import Image

        self._Image = Image
        self.out_dir = out_dir
        self.every = max(every, 1)
        self.count = 0
        self.written = 0
        os.makedirs(out_dir, exist_ok=True)
        inspection.inspect(inspection.PAINTER_ENABLE, True)
        inspection.InspectionSupport.subscribe(
            inspection.PAINTER_FRAME, self._on_frame)

    def _on_frame(self, tap: dict):
        self.count += 1
        if (self.count - 1) % self.every:
            return
        if tap.get("image") is None:
            return
        out = draw_overlay(tap["image"], tap["pts"], tap.get("lengths"))
        self._Image.fromarray(out).save(
            os.path.join(self.out_dir, f"frame_{tap['frame_id']:06d}.png"))
        self.written += 1

    def close(self):
        inspection.unsubscribe(inspection.PAINTER_FRAME, self._on_frame)
        inspection.inspect(inspection.PAINTER_ENABLE, False)

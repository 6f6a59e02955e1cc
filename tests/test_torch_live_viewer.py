"""The port's live web viewer (`xrslam_tpu_torch/tools/live_viewer.py`):
the JAX package's tests (`tests/test_live_viewer.py`) on the port's
module: the page, the JSON state, and the painter-tap frame PNG, whose
overlay is the port's `draw_overlay`, bit-equal to the JAX package's.
Served on 127.0.0.1 only."""

import io
import json
import urllib.request

import numpy as np

from xrslam_tpu.tools import viz as jviz
from xrslam_tpu_torch.tools.live_viewer import LiveViewer
from xrslam_tpu_torch.utils import inspection


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_state_and_page():
    v = LiveViewer(port=0, host="127.0.0.1", subscribe_painter=False)
    try:
        v.publish(pose_q=[1, 0, 0, 0], pose_p=[1.0, 2.0, 3.0],
                  landmarks=np.arange(12.0).reshape(4, 3),
                  stats={"fps": 12.5, "frame": 7})
        v.publish(pose_q=[1, 0, 0, 0], pose_p=[1.5, 2.0, 3.0])

        st, ct, body = _get(v.url)
        assert st == 200 and "text/html" in ct
        assert b"canvas" in body and b"/state.json" in body

        st, ct, body = _get(v.url + "state.json")
        assert st == 200 and "json" in ct
        s = json.loads(body)
        assert s["traj"] == [[1.0, 2.0, 3.0], [1.5, 2.0, 3.0]]
        assert s["pose"]["p"] == [1.5, 2.0, 3.0]
        assert len(s["landmarks"]) == 4
        assert s["stats"]["fps"] == 12.5
    finally:
        v.close()


def test_viewer_painter_frame_png():
    from PIL import Image

    prev = inspection.inspect_get(inspection.PAINTER_ENABLE)
    v = LiveViewer(port=0, host="127.0.0.1")
    try:
        assert inspection.inspect_get(inspection.PAINTER_ENABLE) is True
        img = np.zeros((48, 64), dtype=np.uint8)
        img[10:20, 10:20] = 200
        tap = {"image": img, "pts": np.array([[12.0, 14.0], [40.0, 30.0]]),
               "lengths": np.array([2, 8]), "frame_id": 3, "t": 0.1}
        inspection.inspect(inspection.PAINTER_FRAME, tap)
        st, ct, body = _get(v.url + "frame.png")
        assert st == 200 and ct == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                      jviz.draw_overlay(img, tap["pts"], tap["lengths"]))

        st, _, body = _get(v.url + "state.json")
        assert json.loads(body)["frame_seq"] == 1
    finally:
        v.close()
    assert inspection.inspect_get(inspection.PAINTER_ENABLE) == prev

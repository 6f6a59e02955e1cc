"""With `parsac_flag` off, the PARSAC hook changes nothing: the short
drive of `test_torch_slice.py` (its rendered 320x240 scene, extended to
40 frames so that the sliding window runs) never enters the PARSAC
stage and gives the tracked frames' times bit for bit, and their poses
and the last frame's state to 1e-10, as the port gave them before the
hook existed.

`tests/data/torch_parsac_off_drive.npz` was written by the port of
commit 20da4d3 (the parent of the PARSAC slice), from a checkout of it:

    PYTHONPATH=<checkout of 20da4d3> python tests/test_torch_parsac_golden.py --write

The drive and the writer use only what that commit's port already had.
The test pins 2 intra-op threads, as the writer does: the thread count
changes float64 reductions in the last bits.

The floats cannot be held bit for bit to a file written on another
host. On an Intel Xeon host the drive reproduced the file exactly; on
an AMD EPYC host it parted at the first 5-point essential solve, in
`nullspace_basis` (`tests/torch_call_trace.py`), and ended 8.6e-11 from
it. The repair of the PARSAC chain takes that basis from scipy's LAPACK
on every host (`geometry/essential.py`), so no host meets the file's
bits since. With the polynomial products summed in a fixed order, the
two hosts next part at `torch.linalg.det` (MKL's `getrf`, which picks
its kernel by CPU), later at `torch.linalg.svd` and at torch's own
3-element `sum` in `lie._safe_norm`; the drive ends within 3e-11 of the
file on either host, and 1e-10 is the next decade.
"""

import os
import sys

import numpy as np
import pytest
import torch

from xrslam_tpu_torch import api
from xrslam_tpu_torch.core import sliding_window
from xrslam_tpu_torch.tools.make_dataset import render_sequence, run_sequence

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_parsac_off_drive.npz")
SHORT_FRAMES = 40
THREADS = 2
FLOAT_ATOL = 1e-10


def short_drive() -> dict:
    """Tracked output poses and the last frame's state of the drive."""
    seq = render_sequence(n_frames=SHORT_FRAMES)
    # the file was written under the synchronous anchor (each solve
    # written back at once), before deferred write-backs became the
    # default: published poses one solve ahead of the deferred schedule's
    slam = api.XRSLAM(config=seq["config"].replace(parsac_flag=False,
                                                   deferred_subframe_write=False),
                      device="cpu")
    ts, ps = run_sequence(api, slam, seq, max_frames=SHORT_FRAMES)
    f = slam.pipeline.swt.last_frame_chain()
    return {"ts": ts, "ps": ps, "q": f.q, "p": f.p, "v": f.v, "bg": f.bg, "ba": f.ba}


@pytest.fixture
def golden_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def test_parsac_off_path_bit_identical(golden_threads, monkeypatch):
    def no_parsac(*a, **k):
        raise AssertionError("the PARSAC stage ran with parsac_flag off")

    tracker = sliding_window.SlidingWindowTracker
    monkeypatch.setattr(tracker, "judge_track_status", no_parsac)
    monkeypatch.setattr(tracker, "update_track_status", no_parsac)
    monkeypatch.setattr(tracker, "_stage_prediction", no_parsac)
    out = short_drive()
    ref = np.load(GOLDEN)
    assert len(out["ts"]) == len(ref["ts"]) >= 8
    np.testing.assert_array_equal(np.asarray(out["ts"]), ref["ts"], err_msg="ts")
    for k in ref.files:
        if k != "ts":
            np.testing.assert_allclose(np.asarray(out[k]), ref[k], rtol=0, atol=FLOAT_ATOL,
                                       err_msg=k)


if __name__ == "__main__" and "--write" in sys.argv:
    torch.set_num_threads(THREADS)
    np.savez(GOLDEN, **{k: np.asarray(v) for k, v in short_drive().items()})
    print("wrote", GOLDEN)

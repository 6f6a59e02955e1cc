"""A CPU rehearsal of `chip_smoke.py`'s phase for K1's fused entry.

`klt_track_phase` runs at 320x240 on CPU tensors with the kernel
wrappers patched to their plain versions (the fused entry's stand-in
also fills `steps_out`: min(iters, 3) LK steps per pass on every valid
slot), the CUDA timers stubbed (the device timer returns 0.5, 0.2 and
0.9 ms for the fused entry, the fused entry at iters=1 and the
five-launch chain) and `torch.cuda.synchronize` a no-op. So its
agreement checks, its repeat check and its bound arithmetic run here;
only the card can build and time the kernel.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from xrslam_tpu_torch.frontend import klt  # noqa: E402
from xrslam_tpu_torch.kernels import build  # noqa: E402


def test_klt_track_phase_rehearsal(monkeypatch):
    def fused(prev_pyr, next_pyr, pts_prev, pts_init, valid_in, iters=30,
              steps_out=None, **kw):
        if steps_out is not None:
            steps_out.zero_()
            steps_out[valid_in] = min(iters, 3)
        return klt.track_keypoints_plain(prev_pyr, next_pyr, pts_prev, pts_init,
                                         valid_in, iters=iters, **kw)

    device_times = iter([0.5, 0.2, 0.9])

    monkeypatch.setattr(klt, "track_keypoints_cuda", fused)
    monkeypatch.setattr(klt, "track_level_cuda", klt.track_level_plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps=20, warmup=3: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda fn, calls=20, reps=10: (fn(), next(device_times))[1])
    before = dict(build.KLT_LEVEL.entry_launches)

    res = chip_smoke.klt_track_phase(torch.device("cpu"), width=320, height=240,
                                     focal=260.0)

    assert build.KLT_LEVEL.entry_launches == before
    assert res["status_agreement"] == 1.0 and res["max_abs_err"] == 0.0
    assert res["live"] > 50
    assert res["ms"] == res["plain_ms"] == res["chain_ms"] == 2.0
    assert (res["device_ms"], res["device_ms_iters_1"], res["chain_device_ms"]) \
        == (0.5, 0.2, 0.9)
    # 256 slots, all valid (GFTT fills them at 320x240), 3 steps per pass,
    # so chains of 15 steps, and of 5 at iters=1
    n, levels = 256, 4
    assert res["lk_steps_per_pass"] == [3 * n] * (levels + 1)
    assert res["longest_chain"] == 3 * (levels + 1)
    assert res["us_per_step"] == pytest.approx((0.5 - 0.2) * 1e3 / (15 - 5))
    assert res["latency_floor_us"] == pytest.approx(15 * res["us_per_step"])
    # at 320x240 every level's image is smaller than the blocks read from
    # it, so each image counts whole: 2 pyramids of 4 levels in float32,
    # plus pts/init (N,2) float32, valid (N,) bool, and the outputs
    image_bytes = 4 * sum((240 >> lev) * (320 >> lev) for lev in range(levels))
    assert res["bytes"] == 2 * image_bytes + n * (8 + 8 + 1) + n * (8 + 1)
    passes = n * (levels + 1)
    assert res["flops"] == (21 ** 2 * (3 * passes * chip_smoke.KLT_FLOPS_PER_TAP
                                       + passes * chip_smoke.KLT_WINDOW_FLOPS)
                            + passes * 22 ** 2 * chip_smoke.KLT_SCHARR_FLOPS)
    t_bytes = res["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = res["flops"] / chip_smoke.PEAK_FLOPS[4] * 1e3
    assert res["bound_ms"] == max(t_bytes, t_ops)
    assert res["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")

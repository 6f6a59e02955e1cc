"""The comparison that decides `correct`: the numbers that a run
compares, each against its limit, from what the window produced and
the plain reference (`reference.py`).

Where the reference follows the program step by step, it starts from
the state that the program held before the step (captured by
`taps.py`) and the number is the distance of the program's answer from
the reference's:

- `solve_gap`: window solves, one of each kind (frame count, rotation
  mode, iteration count) drawn from the seed: the relative difference
  of the two solved windows' costs, by the reference's cost function;
- `marg_gap`: marginalizations, `check_samples` drawn from the seed:
  the relative distance of the priors' information matrix and vector;
- `track_lost_share`: K1, the frame pairs drawn from the seed, on the
  program's own pyramids: the share of the live slots whose verdict
  (kept or lost) differs from the reference's;
- `track_gap_px`: the same pairs: the largest distance of a tracked
  position from the reference's, over the slots both sides keep;
- `pyramid_gap`: the program's pyramids of those frames against the
  reference's CLAHE and pyramid of the same camera image: the largest
  absolute difference (gray levels) of any pixel of any level;
- `pnp_gap_m` (configurations with the camera-rate PnP): PnP refines
  drawn from the seed: the distance (m) of the camera positions;
- `pose_gap_m`: every published pose of the window: the distance (m)
  from the reference's IMU propagation of the solved state it was
  propagated from, carried to the time of the frame it was published
  for (a pose left at an older time is off by the motion since).

`ate_m`, the published positions against the ground truth (RMSE after
a rigid alignment), starts from nothing of the program's; its limit is
the accuracy that the configuration states.

The control puts the reference in the program's place, one precision
below the program's (float32 for the float64 solves, marginalization,
PnP and propagation; bfloat16 for the float32 frontend), and has to
fail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

# Each limit lies between the readings it was set from (PERF.md, section
# 2, gives them), with more room above the largest reading of sound runs
# over a dozen seeds than below the smallest of the control. The
# pyramid's sound readings reach 0.78: the program's float32 CLAHE table
# rounds an entry that lies within rounding of a half the other way, one
# gray level, which the bilinear blend and the blur keep under 1.
LIMITS = {
    "solve_gap": 1e-10,
    "marg_gap": 1e-8,
    "track_lost_share": 0.05,
    "track_gap_px": 0.35,
    "pyramid_gap": 2.0,
    "pnp_gap_m": 1e-10,
    "pose_gap_m": 1e-11,
}


def readings(cap: dict, control: bool = False) -> dict:
    """Every number of a run from its captured samples (`cap`); with
    `control` the answers judged are the reference's one precision
    down instead of the program's."""
    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    out = {}
    if cap["solves"]:
        gaps = []
        for c in cap["solves"]:
            ref = reference.solve_window(c["state"], c["data"], c["opts"], f64)
            got = (reference.solve_window(c["state"], c["data"], c["opts"], f32)
                   if control else c["out"])
            gaps.append(reference.solve_gap(got, ref, c["data"], c["opts"]))
        out["solve_gap"] = max(gaps)
    if cap["margs"]:
        gaps = []
        for c in cap["margs"]:
            H, b = reference.marginalize(c["state"], c["data"], c["victim"],
                                         c["kw"].get("eig_clamp", 1e-8), f64)
            if control:
                Hc, bc = reference.marginalize(c["state"], c["data"], c["victim"],
                                               c["kw"].get("eig_clamp", 1e-8), f32)
            else:
                U, iv = (x.double() for x in c["out"])
                Hc, bc = U.T @ U, U.T @ iv
            gaps.append(reference.marg_gap(Hc, bc, H, b))
        out["marg_gap"] = max(gaps)
    if cap["tracks"]:
        lost, t_gaps, p_gaps = [], [], []
        for c in cap["tracks"]:
            kw = {k: v for k, v in c["kw"].items()
                  if k in ("win", "iters", "eps", "border", "reverse_thresh", "max_residual")}
            args = (c["prev_pyr"], c["next_pyr"], c["pts"], c["init"], c["valid"])
            ref = reference.track(*args, **kw, dtype=f64)
            got = reference.track(*args, **kw, dtype=bf16) if control else c["out"]
            share, gap = reference.track_gap(*got, *ref, c["valid"])
            lost.append(share)
            t_gaps.append(gap)
            img = torch.from_numpy(cap["stream"].images[cap["frame0"] + c["frame"]]).to(
                c["next_pyr"][0].device)
            prm = cap["pyramid"]
            pyr = reference.pyramid(img, len(c["next_pyr"]) - 1, *prm, f64)
            got_p = (reference.pyramid(img, len(c["next_pyr"]) - 1, *prm, bf16)
                     if control else c["next_pyr"])
            p_gaps.append(max(float((a.double() - b).abs().max()) for a, b in zip(got_p, pyr)))
        out["track_lost_share"] = max(lost)
        out["track_gap_px"] = max(t_gaps)
        out["pyramid_gap"] = max(p_gaps)
    if cap["pnp"]:
        gaps = []
        for c in cap["pnp"]:
            q_wc, p_wc, X, b, valid, W2 = c["args"]
            damping = c["kw"].get("damping", 1e-6)
            _, p_ref = reference.refine_pnp(q_wc, p_wc, X, b, valid, W2, c["iters"],
                                            damping, f64)
            p = (reference.refine_pnp(q_wc, p_wc, X, b, valid, W2, c["iters"], damping, f32)[1]
                 if control else c["out"][1])
            gaps.append(float(torch.linalg.vector_norm(p.double() - p_ref)))
        out["pnp_gap_m"] = max(gaps)
    st = cap["stream"]
    gaps = []
    for f in cap["poses"]:
        pose = f["pose"]
        if control:
            pose = dict(pose, p=reference.propagate(f["prop"], st.imu_t, st.imu_w, st.imu_a,
                                                    f["t_due"], np.float32)[1])
        gaps.append(reference.pose_gap(pose, f["prop"], st, f["t_due"]))
    if gaps:
        out["pose_gap_m"] = max(gaps)
    return out

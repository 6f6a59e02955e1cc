"""AR virtual-object anchoring (port of `xrslam_tpu/ar.py`).

Places virtual objects on clusters of triangulated landmarks near the
image center, with orientation built from the camera ray and
gravity-up (reference: xrslam/src/xrslam/ar/
virtual_object_manager.cpp:19-73). The SLAM frame is gravity-aligned
after initialization, so `up = +z`."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .core import nputil
from .core.map import FrameRec, PipelineMap

_vo_id = itertools.count(1)


@dataclass
class VirtualObject:
    id: int
    q: np.ndarray           # [w,x,y,z] object-to-world
    p: np.ndarray           # (3,)
    local_landmarks: List[np.ndarray] = field(default_factory=list)
    isolated: bool = False


class VirtualObjectManager:
    """reference VirtualObjectManager (keypoint_radius 0.1 ≈ the
    central cone in normalized image coords, ≥5 supporting landmarks,
    virtual_object_manager.cpp:11-38)."""

    def __init__(self, pmap: PipelineMap, localizer=None,
                 keypoint_radius: float = 0.1, min_landmarks: int = 5):
        self.map = pmap
        self.localizer = localizer
        self.keypoint_radius = keypoint_radius
        self.min_landmarks = min_landmarks
        self.objects: Dict[int, VirtualObject] = {}

    def create_virtual_object(self) -> int:
        """Anchor a new object at the centroid of triangulated
        landmarks observed near the image center of the newest frame.
        Returns the object id, or -1 (reference :36-38) if fewer than
        `min_landmarks` support it."""
        if not self.map.frames:
            return -1
        frame = self.map.frames[-1]
        near = []
        for k in np.nonzero(frame.track_ids >= 0)[0]:
            tr = self.map.get_track(frame, int(k))
            if tr is None or not tr.triangulated or tr.p_w is None:
                continue
            b = frame.bearings[int(k)]
            if abs(b[2]) < 1e-9:
                continue
            h = b[:2] / b[2]  # hnormalized
            if (abs(h[0]) > self.keypoint_radius
                    or abs(h[1]) > self.keypoint_radius):
                continue
            near.append(np.asarray(tr.p_w, float))
        if len(near) < self.min_landmarks:
            return -1

        origin = np.mean(near, axis=0)
        q_wc, p_wc = frame.camera_pose()
        central_ray = p_wc - origin
        central_ray /= max(np.linalg.norm(central_ray), 1e-12)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(up, central_ray)
        right /= max(np.linalg.norm(right), 1e-12)
        backward = np.cross(right, up)
        backward /= max(np.linalg.norm(backward), 1e-12)
        R = np.stack([-up, right, backward], axis=1)  # columns (:47-50)
        q = nputil.matrix_to_quat(R)
        p = origin

        obj = VirtualObject(
            id=next(_vo_id), q=q, p=p,
            local_landmarks=[R.T @ (lm - origin) for lm in near])
        if self.localizer is not None and self.localizer.is_initialized():
            obj.q, obj.p = self.localizer.transform(obj.q, obj.p)
            obj.isolated = True
        self.objects[obj.id] = obj
        return obj.id

    def get_virtual_object_pose(self, oid: int) -> Optional[VirtualObject]:
        return self.objects.get(oid)

    def update_virtual_objects(self) -> None:
        """reference :76 — objects stay anchored to their creation pose
        (landmark refinement does not move them)."""
        return

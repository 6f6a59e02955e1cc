"""Pinhole camera model with radial-tangential distortion, batched over
leading axes (port of `xrslam_tpu/geometry/camera.py`)."""

from __future__ import annotations

import torch


def apply_k(p: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (...,3) to pixels (...,2) with
    intrinsics K (3,3)."""
    z = p[..., 2]
    return torch.stack([p[..., 0] / z * K[..., 0, 0] + K[..., 0, 2],
                        p[..., 1] / z * K[..., 1, 1] + K[..., 1, 2]], dim=-1)


def remove_k(p: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> unit bearing vectors (...,3)."""
    v = torch.stack([(p[..., 0] - K[..., 0, 2]) / K[..., 0, 0],
                     (p[..., 1] - K[..., 1, 2]) / K[..., 1, 1],
                     torch.ones_like(p[..., 0])], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def dproj_dp(p: torch.Tensor) -> torch.Tensor:
    """Jacobian of the perspective division h(p) = (x/z, y/z):
    (...,3) -> (...,2,3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    return torch.stack([torch.stack([iz, zero, -x * iz2], dim=-1),
                        torch.stack([zero, iz, -y * iz2], dim=-1)], dim=-2)


def _coefficients(dist: torch.Tensor):
    """(k1, k2, p1, p2, k3) of an OpenCV (k1,k2,p1,p2[,k3]) vector."""
    k3 = dist[..., 4] if dist.shape[-1] > 4 else torch.zeros_like(dist[..., 0])
    return dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3], k3


def distort_radtan(p_norm: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized image
    coordinates (...,2)."""
    k1, k2, p1, p2, k3 = _coefficients(dist)
    x, y = p_norm[..., 0], p_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_radtan(p_dist: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert radial-tangential distortion by a fixed number of
    fixed-point iterations (cv::undistortPoints' scheme)."""
    k1, k2, p1, p2, k3 = _coefficients(dist)
    p = p_dist
    for _ in range(iters):
        x, y = p[..., 0], p[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        p = torch.stack([(p_dist[..., 0] - dx) / radial,
                         (p_dist[..., 1] - dy) / radial], dim=-1)
    return p


def undistort_pixels(uv: torch.Tensor, K: torch.Tensor,
                     dist: torch.Tensor) -> torch.Tensor:
    """Distorted pixels -> undistorted pixels under the same K."""
    xn = torch.stack([(uv[..., 0] - K[..., 0, 2]) / K[..., 0, 0],
                      (uv[..., 1] - K[..., 1, 2]) / K[..., 1, 1]], dim=-1)
    xu = undistort_radtan(xn, dist)
    return torch.stack([xu[..., 0] * K[..., 0, 0] + K[..., 0, 2],
                        xu[..., 1] * K[..., 1, 1] + K[..., 1, 2]], dim=-1)

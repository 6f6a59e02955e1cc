"""Quaternion and rotation arithmetic of the benchmark's own, in plain
PyTorch: the traffic generator and the reference both use it, and
neither imports the program under test.

Quaternions are [w, x, y, z], Hamilton product; q rotates a vector from
the body frame to the world frame. Every function broadcasts over
leading axes, and `expmap`/`logmap` stay differentiable at zero, so the
reference can take its Jacobians with `torch.func`.
"""

from __future__ import annotations

import torch

_SMALL = 1e-3


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, with a finite gradient at v = 0."""
    sq = torch.sum(v * v, dim=-1)
    pos = sq > 0
    return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos.to(v.dtype)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qnormalize(q):
    return q / _norm(q)[..., None]


def rotate(q, v):
    """R(q) v."""
    u = q[..., 1:]
    t = 2.0 * cross(u, v)
    return v + q[..., :1] * t + cross(u, t)


def rotate_inv(q, v):
    """R(q)ᵀ v."""
    return rotate(qconj(q), v)


def qmatrix(q):
    """R(q) as a (..., 3, 3) matrix."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return torch.stack([rotate(q, eye[i].expand(q.shape[:-1] + (3,)))
                        for i in range(3)], dim=-1)


def expmap(w):
    """Unit quaternion of the rotation vector w."""
    a = _norm(w)
    h = 0.5 * a
    s = torch.where(a > _SMALL, torch.sin(h) / torch.where(a > 0, a, torch.ones_like(a)),
                    0.5 - a * a / 48.0)
    return torch.cat([torch.cos(h)[..., None], s[..., None] * w], dim=-1)


def logmap(q):
    """Rotation vector of the unit quaternion q, angle in [0, pi]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    n = _norm(q[..., 1:])
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    small = n <= _SMALL
    one = torch.ones_like(n)
    f = torch.where(small,
                    2.0 / torch.where(w > 0, w, one) * (1.0 - n * n / (3.0 * w * w)),
                    2.0 * torch.atan2(n, w) / torch.where(small, one, n))
    return f[..., None] * q[..., 1:]


def tangent_basis(b):
    """(..., 3, 2) orthonormal basis of the plane normal to the unit
    vector b: t1 = b × e, e the axis after b's largest component, and
    t2 = b × t1 (zero for b = 0)."""
    d = torch.argmax(torch.abs(b), dim=-1)
    e = torch.nn.functional.one_hot((d + 1) % 3, 3).to(b.dtype)

    def unit(v):
        n = _norm(v)
        return v / torch.where(n > 0, n, torch.ones_like(n))[..., None]

    t1 = unit(cross(b, e))
    return torch.stack([t1, unit(cross(b, t1))], dim=-1)

"""2-D coordinate frames with covariance transport (port of the JAX
package's ``core/frame2d.py``).

Reference: ``Frame2d`` (Frame.hpp:40-113, src/Frame.cpp): SE(2)
composition, point transforms and a frame expressed relative to the base
frame, the pose covariance carried through the composition Jacobians.
The reference filters do not use it (an analysis aid).

A frame is ``(pose [..., 3], cov [..., 3, 3])`` with pose = (x, y, theta).
"""

from __future__ import annotations

import torch

from rfs_slam_tpu_torch.core import gaussian


def _sandwich(J, cov):
    return J @ cov @ J.transpose(-1, -2)


def compose(pose_a, cov_a, pose_b, cov_b):
    """Frame composition c = a * b (b expressed in a's frame), batched over
    leading dims; cov_c = J_a cov_a J_a^T + J_b cov_b J_b^T."""
    xa, ya, ta = pose_a[..., 0], pose_a[..., 1], pose_a[..., 2]
    xb, yb, tb = pose_b[..., 0], pose_b[..., 1], pose_b[..., 2]
    c, s = torch.cos(ta), torch.sin(ta)
    xc = xa + c * xb - s * yb
    yc = ya + s * xb + c * yb
    tc = gaussian.wrap_angle(ta + tb)
    pose_c = torch.stack([xc, yc, tc], dim=-1)

    zero = torch.zeros_like(xa)
    one = torch.ones_like(xa)
    # d(pose_c)/d(pose_a) and d(pose_c)/d(pose_b)
    Ja = gaussian.matrix([[one, zero, -s * xb - c * yb],
                          [zero, one, c * xb - s * yb],
                          [zero, zero, one]])
    Jb = gaussian.matrix([[c, -s, zero], [s, c, zero], [zero, zero, one]])
    return pose_c, _sandwich(Ja, cov_a) + _sandwich(Jb, cov_b)


def inverse(pose, cov):
    """Frame inverse: a * inv(a) = identity, with covariance transport."""
    x, y, t = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    xi = -(c * x + s * y)
    yi = s * x - c * y
    pose_i = torch.stack([xi, yi, -t], dim=-1)
    zero = torch.zeros_like(x)
    J = gaussian.matrix([[-c, -s, yi],
                         [s, -c, -xi],
                         [zero, zero, -torch.ones_like(x)]])
    return pose_i, _sandwich(J, cov)


def transform_point(pose, point):
    """``point`` (given in the frame of ``pose``) in the base frame."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    x = pose[..., 0] + c * point[..., 0] - s * point[..., 1]
    y = pose[..., 1] + s * point[..., 0] + c * point[..., 1]
    return torch.stack([x, y], dim=-1)


def chain_to_base(poses, covs):
    """Compose a chain of relative frames into base-frame frames.

    ``poses [T, 3]``: frame t expressed in frame t-1 (frame 0 relative to
    the base), ``covs [T, 3, 3]``.  Returns the absolute ``(poses [T, 3],
    covs [T, 3, 3])``: the getRelToBaseFrame chain (Frame.hpp:86-113), T
    dependent compositions carrying ``(pose, cov)``.
    """
    p = torch.zeros(3, dtype=poses.dtype, device=poses.device)
    c = torch.zeros((3, 3), dtype=poses.dtype, device=poses.device)
    out_p, out_c = [], []
    for t in range(poses.shape[0]):
        p, c = compose(p, c, poses[t], covs[t])
        out_p.append(p)
        out_c.append(c)
    return torch.stack(out_p), torch.stack(out_c)

"""Rotation, projection and affine-crop geometry, batched over leading dims.

Port of ``spacecraft_pose_estimation_tpu/ops/geometry.py``. Where the JAX
functions take one example (and are vmapped), these take any number of
leading batch dims. Everything runs in float32; the small matrix products
are written as broadcast multiply + sum (``mm``), so they are full float32
whatever the process-wide TF32 flags say (the JAX module pins
``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

PIXEL_STD = 200.0  # the HRNet-lineage scale unit (JointsDataset.py pixel_std)


def mm(a: Tensor, b: Tensor) -> Tensor:
    """Batched ``a @ b`` in exact float32 (no TF32): (..., n, k) x (..., k, m)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def quat_to_dcm(q: Tensor) -> Tensor:
    """Scalar-first quaternion (..., 4) -> world->body DCM (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q0, q1, q2, q3 = q.unbind(-1)
    rows = [
        [2 * q0**2 - 1 + 2 * q1**2, 2 * q1 * q2 + 2 * q0 * q3, 2 * q1 * q3 - 2 * q0 * q2],
        [2 * q1 * q2 - 2 * q0 * q3, 2 * q0**2 - 1 + 2 * q2**2, 2 * q2 * q3 + 2 * q0 * q1],
        [2 * q1 * q3 + 2 * q0 * q2, 2 * q2 * q3 - 2 * q0 * q1, 2 * q0**2 - 1 + 2 * q3**2],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rotmat(q: Tensor) -> Tensor:
    """Scalar-first quaternion (..., 4) -> standard (body->world) rotation matrix (..., 3, 3)."""
    return quat_to_dcm(q).transpose(-1, -2)


def rotmat_to_quat(r: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> scalar-first quaternion (..., 4).

    Branchless Shepperd extraction: the largest of the four diagonal
    candidates (first on ties) anchors the quaternion.
    """
    r00, r11, r22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    e0 = torch.sqrt(torch.clamp(1 + r00 + r11 + r22, min=0.0)) / 2
    e1 = torch.sqrt(torch.clamp(1 + r00 - r11 - r22, min=0.0)) / 2
    e2 = torch.sqrt(torch.clamp(1 - r00 + r11 - r22, min=0.0)) / 2
    e3 = torch.sqrt(torch.clamp(1 - r00 - r11 + r22, min=0.0)) / 2
    idx = torch.argmax(torch.stack([e0, e1, e2, e3], dim=-1), dim=-1)

    def safe(d):
        return torch.where(torch.abs(d) > 1e-12, d, torch.ones_like(d))

    d0, d1, d2, d3 = safe(4 * e0), safe(4 * e1), safe(4 * e2), safe(4 * e3)
    a01, a02, a12 = r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]
    s01, s02, s12 = r[..., 1, 0] + r[..., 0, 1], r[..., 2, 0] + r[..., 0, 2], r[..., 2, 1] + r[..., 1, 2]
    candidates = torch.stack(
        [
            torch.stack([e0, a01 / d0, a02 / d0, a12 / d0], dim=-1),
            torch.stack([a01 / d1, e1, s01 / d1, s02 / d1], dim=-1),
            torch.stack([a02 / d2, s01 / d2, e2, s12 / d2], dim=-1),
            torch.stack([a12 / d3, s02 / d3, s12 / d3, e3], dim=-1),
        ],
        dim=-2,
    )
    return torch.gather(candidates, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]


def skew(v: Tensor) -> Tensor:
    """(..., 3) -> skew-symmetric cross-product matrices (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec: Tensor) -> Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (cv2.Rodrigues)."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)
    big = theta > 1e-12
    safe_theta = torch.where(big, theta, torch.ones_like(theta))
    K = skew(rvec / safe_theta[..., None])
    s, c = torch.sin(theta)[..., None, None], torch.cos(theta)[..., None, None]
    eye = _eye(3, rvec)
    R = eye + s * K + (1 - c) * mm(K, K)
    return torch.where(big[..., None, None], R, eye + skew(rvec))


def rotmat_to_rodrigues(r: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) (cv2.Rodrigues inverse).

    The axis comes from the skew part, or, where sin(theta) <= 1e-6 (theta
    near pi, where the skew part vanishes), from the diagonal with the skew
    part's signs (a zero skew entry counts as positive): the JAX package's
    rule, not cv2's.
    """
    cos_theta = torch.clamp((r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    axis_raw = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_theta = torch.sin(theta)
    generic = (torch.abs(sin_theta) > 1e-6)[..., None]
    axis_generic = axis_raw / torch.where(generic, 2 * sin_theta[..., None], torch.ones_like(axis_raw))
    diag_axis = torch.sqrt(torch.clamp((torch.diagonal(r, dim1=-2, dim2=-1) + 1) / 2, min=0.0))
    axis_pi = diag_axis * torch.sign(torch.where(axis_raw == 0, torch.ones_like(axis_raw), axis_raw))
    axis_pi = axis_pi / torch.clamp(torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True), min=1e-12)
    axis = torch.where(generic, axis_generic, axis_pi)
    return torch.where((theta > 1e-12)[..., None], axis * theta[..., None], torch.zeros_like(axis))


def distort_normalized(xy: Tensor, dist: Tensor) -> Tensor:
    """OpenCV Brown distortion (k1, k2, p1, p2, k3) of normalized (..., 2)."""
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_dist: Tensor, dist: Tensor, iters: int = 8) -> Tensor:
    """Invert Brown distortion by fixed-point iteration (cv2.undistortPoints)."""
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = torch.stack([(xy_dist[..., 0] - dx) / radial, (xy_dist[..., 1] - dy) / radial], dim=-1)
    return xy


def project_points(points: Tensor, R: Tensor, t: Tensor, K: Tensor, dist: Tensor) -> Tensor:
    """World points (..., N, 3) -> pixels (..., N, 2) through K [R|t] + distortion.

    ``R`` (..., 3, 3) is world->camera and ``t`` (..., 3).
    """
    p_cam = mm(points, R.transpose(-1, -2)) + t[..., None, :]
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    xy = distort_normalized(xy, dist)
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def pixels_to_normalized(uv: Tensor, K: Tensor, dist: Tensor, iters: int = 8) -> Tensor:
    """Pixels (..., 2) -> undistorted normalized image-plane coordinates."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return undistort_normalized(torch.stack([x, y], dim=-1), dist, iters=iters)


def crop_affine_matrix(
    center: Tensor,
    scale: Tensor,
    rot_deg: Tensor | float,
    output_size: tuple[int, int],
    inv: bool = False,
) -> Tensor:
    """(..., 2, 3) similarity mapping a scale*200 box at ``center`` to the output.

    ``center`` and ``scale`` are (..., 2); only ``scale[..., 0]`` sets the
    size. ``output_size`` is (width, height). ``inv=True`` gives the
    dst -> src map used to sample crops and to lift heatmap peaks back.
    """
    center = center.to(torch.float32)
    scale = scale.to(torch.float32)
    src_w = scale[..., 0] * PIXEL_STD
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    s = dst_w / src_w
    rot = -torch.deg2rad(torch.as_tensor(rot_deg, dtype=torch.float32, device=center.device))
    rot = torch.broadcast_to(rot, s.shape)
    cs, sn = torch.cos(rot), torch.sin(rot)
    dst_c = torch.tensor([dst_w * 0.5, dst_h * 0.5], dtype=torch.float32, device=center.device)
    if inv:
        A = torch.stack([torch.stack([cs, sn], -1), torch.stack([-sn, cs], -1)], -2) / s[..., None, None]
        b = center - mm(A, dst_c[:, None].expand(*A.shape[:-2], 2, 1))[..., 0]
    else:
        A = s[..., None, None] * torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)], -2)
        b = dst_c - mm(A, center[..., None])[..., 0]
    return torch.cat([A, b[..., None]], dim=-1)


def apply_affine(points: Tensor, M: Tensor) -> Tensor:
    """Apply (..., 2, 3) affines to (..., N, 2) points."""
    return mm(points, M[..., :2].transpose(-1, -2)) + M[..., None, :, 2]


def transform_preds(coords: Tensor, center: Tensor, scale: Tensor, output_size) -> Tensor:
    """Heatmap coords (..., N, 2) -> source-image coords (transforms.py:49-54)."""
    return apply_affine(coords, crop_affine_matrix(center, scale, 0.0, output_size, inv=True))


def bbox_to_center_scale(bbox_xywh: Tensor, padding: float = 1.5) -> tuple[Tensor, Tensor]:
    """COCO xywh (..., 4) -> centers (..., 2), scales (..., 2) (events.py:98-113)."""
    x, y, w, h = bbox_xywh.unbind(-1)
    center = torch.stack([x + w * 0.5, y + h * 0.5], dim=-1)
    scale = torch.stack([w, h], dim=-1) * padding / PIXEL_STD
    return center, scale


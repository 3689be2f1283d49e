"""Batched PnP: weighted EPnP + Gauss-Newton refine, fixed depth, no cv2.

Port of ``spacecraft_pose_estimation_tpu/ops/pnp.py`` (the ``solver="gn"``
path). Every function takes leading batch dims where the JAX ones are
vmapped. The algorithm is the same fixed-depth one: Gauss-Jordan inverses,
shifted (inverse) power iteration with repeated squaring in place of
eigh/SVD, Horn's quaternion Kabsch, and the finite-fallback chain. The
Gauss-Newton Jacobian is written out analytically where the JAX module
takes ``jacfwd`` of the same projection. All products go through
``geometry.mm`` (exact float32, never TF32).
"""

from __future__ import annotations

import torch

from . import geometry
from .geometry import mm

Tensor = torch.Tensor


def adaptive_confidence_mask(
    conf: Tensor, init_threshold: float = 0.95, decay: float = 0.8,
    min_count: int = 15, max_iters: int = 100,
) -> Tensor:
    """Largest threshold in {init * decay**k} keeping >= min_count points (..., N).

    If none does within ``max_iters`` decays, the smallest threshold is used.
    """
    ks = torch.arange(max_iters + 1, dtype=torch.float32, device=conf.device)
    thresholds = init_threshold * decay**ks
    counts = (conf[..., None, :] > thresholds[:, None]).sum(-1)  # (..., K)
    meets = counts >= min_count
    first = torch.argmax(meets.to(torch.int32), dim=-1)
    k = torch.where(meets.any(-1), first, torch.full_like(first, max_iters))
    return conf > thresholds[k][..., None]


def _fro(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=(-2, -1))


def _gj_inverse(A: Tensor) -> Tensor:
    """Gauss-Jordan inverse without pivoting, pivots magnitude-clamped at 1e-20
    (a singular input gives a finite, garbage inverse)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)
    for k in range(n):
        piv = aug[..., k, k]
        tiny = torch.where(piv < 0, torch.full_like(piv, -1e-20), torch.full_like(piv, 1e-20))
        piv = torch.where(torch.abs(piv) >= 1e-20, piv, tiny)
        row_k = aug[..., k, :] / piv[..., None]
        upd = aug - aug[..., :, k, None] * row_k[..., None, :]
        upd[..., k, :] = row_k
        aug = upd
    return aug[..., n:]


def _max_norm_column_polish(B: Tensor) -> Tensor:
    """Seed with B's largest-norm column, one polish step, normalize."""
    j = torch.argmax((B * B).sum(-2), dim=-1)
    v = torch.gather(B, -1, j[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    v = mm(B / torch.clamp(_fro(B), min=1e-30)[..., None, None], v[..., None])[..., 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _min_eigvec_pd(A: Tensor, shift_rel: float = 1e-6) -> Tensor:
    """Smallest-eigenvalue eigenvector of PSD matrices: (A + eps I)^-1 squared 3 times."""
    n = A.shape[-1]
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n + 1e-30
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    B = _gj_inverse(A + (shift_rel * scale + 1e-12)[..., None, None] * eye)
    for _ in range(3):
        B = B / _fro(B)[..., None, None]
        B = mm(B, B)
    return _max_norm_column_polish(B)


def _max_eigvec_sym4(K: Tensor) -> Tensor:
    """Largest-eigenvalue eigenvector of symmetric 4x4s: (K + |K| I) squared 7 times."""
    A = K + _fro(K)[..., None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    for _ in range(7):
        A = A / torch.clamp(_fro(A), min=1e-30)[..., None, None]
        A = mm(A, A)
    return _max_norm_column_polish(A)


def _control_and_alphas(world: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """4 control points (weighted centroid + axis-aligned weighted-std basis)
    and closed-form barycentric coordinates: (..., 4, 3), (..., N, 4)."""
    wsum = torch.clamp(w.sum(-1), min=1e-8)[..., None]
    c0 = (world * w[..., None]).sum(-2) / wsum
    centered = world - c0[..., None, :]
    var = (centered**2 * w[..., None]).sum(-2) / wsum
    floor = torch.clamp(1e-6 * var.amax(-1, keepdim=True), min=1e-10)
    scale = torch.sqrt(torch.maximum(var, floor))
    ctrl = torch.cat([c0[..., None, :], c0[..., None, :] + torch.diag_embed(scale)], dim=-2)
    a123 = centered / scale[..., None, :]
    a0 = 1.0 - a123.sum(-1)
    return ctrl, torch.cat([a0[..., None], a123], dim=-1)


def _kabsch(world: Tensor, cam: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """Weighted rigid alignment cam ~= R world + t by Horn's quaternion method."""
    wsum = torch.clamp(w.sum(-1), min=1e-8)[..., None]
    mw = (world * w[..., None]).sum(-2) / wsum
    mc = (cam * w[..., None]).sum(-2) / wsum
    S = mm(((world - mw[..., None, :]) * w[..., None]).transpose(-1, -2), cam - mc[..., None, :])
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    rows = [
        [sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz],
    ]
    N = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    q0, qx, qy, qz = _max_eigvec_sym4(N).unbind(-1)
    rrows = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - q0 * qz), 2 * (qx * qz + q0 * qy)],
        [2 * (qx * qy + q0 * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - q0 * qx)],
        [2 * (qx * qz - q0 * qy), 2 * (qy * qz + q0 * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    R = torch.stack([torch.stack(r, dim=-1) for r in rrows], dim=-2)
    t = mc - mm(R, mw[..., None])[..., 0]
    return R, t


_IU = (0, 0, 0, 1, 1, 2)  # jnp.triu_indices(4, k=1)
_JU = (1, 2, 3, 2, 3, 3)


def epnp(world: Tensor, img_norm: Tensor, weights: Tensor) -> tuple[Tensor, Tensor]:
    """Weighted EPnP (beta-1 case + rigid alignment).

    world (..., N, 3), img_norm (..., N, 2) undistorted normalized coords,
    weights (..., N) -> world->camera R (..., 3, 3), t (..., 3).
    """
    n = world.shape[-2]
    w = weights.to(torch.float32)
    ctrl, alpha = _control_and_alphas(world, w)
    u, v = img_norm[..., 0], img_norm[..., 1]
    sw = torch.sqrt(w)[..., None]
    zeros = torch.zeros_like(alpha)
    rx = torch.stack([alpha, zeros, -alpha * u[..., None]], dim=-1)  # (..., N, 4, 3)
    ry = torch.stack([zeros, alpha, -alpha * v[..., None]], dim=-1)
    lead = alpha.shape[:-2]
    M = torch.cat([rx.reshape(*lead, n, 12) * sw, ry.reshape(*lead, n, 12) * sw], dim=-2)
    x = _min_eigvec_pd(mm(M.transpose(-1, -2), M)).reshape(*lead, 4, 3)

    dc = torch.linalg.vector_norm(ctrl[..., _IU, :] - ctrl[..., _JU, :], dim=-1)
    dv = torch.linalg.vector_norm(x[..., _IU, :] - x[..., _JU, :], dim=-1)
    beta = (dv * dc).sum(-1) / torch.clamp((dv * dv).sum(-1), min=1e-12)
    cam = mm(alpha, beta[..., None, None] * x)  # (..., N, 3)
    sign = torch.sign((cam[..., 2] * w).sum(-1) + 1e-12)
    return _kabsch(world, cam * sign[..., None, None], w)


def _project_with_jacobian(world, R, t, K, dist):
    """Pixels (..., N, 2) and d(pixels)/d(delta) (..., N, 2, 6) at delta = 0,
    for the update p_cam' = exp(delta_rot^) p_cam + delta_t."""
    P = mm(world, R.transpose(-1, -2)) + t[..., None, :]
    X, Y, Z = P.unbind(-1)
    x, y = X / Z, Y / Z
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    dradial = k1 + 2 * k2 * r2 + 3 * k3 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    uv = torch.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], dim=-1)

    dxd_dx = radial + 2 * x * x * dradial + 2 * p1 * y + 6 * p2 * x
    dxd_dy = 2 * x * y * dradial + 2 * p1 * x + 2 * p2 * y
    dyd_dx = 2 * x * y * dradial + 2 * p1 * x + 2 * p2 * y
    dyd_dy = radial + 2 * y * y * dradial + 6 * p1 * y + 2 * p2 * x
    inv_z = 1.0 / Z
    zero = torch.zeros_like(Z)
    dx_dP = torch.stack([inv_z, zero, -x * inv_z], dim=-1)
    dy_dP = torch.stack([zero, inv_z, -y * inv_z], dim=-1)
    du_dP = K[0, 0] * (dxd_dx[..., None] * dx_dP + dxd_dy[..., None] * dy_dP)
    dv_dP = K[1, 1] * (dyd_dx[..., None] * dx_dP + dyd_dy[..., None] * dy_dP)
    # dP/d(delta_rot) = -[P]x, so d(g . P)/d(delta_rot) = P x g
    J = torch.stack(
        [
            torch.cat([torch.linalg.cross(P, du_dP, dim=-1), du_dP], dim=-1),
            torch.cat([torch.linalg.cross(P, dv_dP, dim=-1), dv_dP], dim=-1),
        ],
        dim=-2,
    )
    return uv, J


def refine_pose(
    R: Tensor, t: Tensor, world: Tensor, img_px: Tensor, K: Tensor, dist: Tensor,
    weights: Tensor, iters: int = 10, damping: float = 1e-6,
) -> tuple[Tensor, Tensor]:
    """Damped Gauss-Newton on the weighted pixel reprojection error.

    A step is taken only where it keeps the pose finite; non-finite
    Jacobian or residual entries (points at or behind the camera) are zeroed.
    """
    lead = R.shape[:-2]
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        uv, J = _project_with_jacobian(world, R, t, K, dist)
        r = ((uv - img_px) * weights[..., None]).reshape(*lead, -1)
        J = (J * weights[..., None, None]).reshape(*lead, -1, 6)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J))
        r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
        JT = J.transpose(-1, -2)
        A = mm(JT, J) + damping * eye6
        g = mm(JT, r[..., None])[..., 0]
        delta = -mm(_gj_inverse(A), g[..., None])[..., 0]
        dR = geometry.rodrigues(delta[..., :3])
        Rn = mm(dR, R)
        tn = mm(dR, t[..., None])[..., 0] + delta[..., 3:]
        ok = torch.isfinite(Rn).all(-1).all(-1) & torch.isfinite(tn).all(-1)
        R = torch.where(ok[..., None, None], Rn, R)
        t = torch.where(ok[..., None], tn, t)
    return R, t


def _identity_pose(world: Tensor) -> tuple[Tensor, Tensor]:
    """Finite last-resort pose: identity, target one model-diameter ahead."""
    span = torch.linalg.vector_norm(world - world.mean(-2, keepdim=True), dim=-1).amax(-1)
    z = torch.clamp(2.0 * span, min=1.0)
    R = torch.eye(3, dtype=world.dtype, device=world.device).expand(*z.shape, 3, 3)
    t = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], dim=-1)
    return R, t


def _first_finite_pose(candidates: list[tuple[Tensor, Tensor]]) -> tuple[Tensor, Tensor]:
    """Per batch element, the first all-finite (R, t) in priority order;
    the last candidate is finite by construction."""
    R, t = candidates[-1]
    for Rc, tc in reversed(candidates[:-1]):
        ok = torch.isfinite(Rc).all(-1).all(-1) & torch.isfinite(tc).all(-1)
        R = torch.where(ok[..., None, None], Rc, R)
        t = torch.where(ok[..., None], tc, t)
    return R, t


def _norm_pts(img_px: Tensor, K: Tensor, dist: Tensor) -> Tensor:
    return geometry.pixels_to_normalized(img_px, K, dist, iters=10)


def solve_pnp(
    world: Tensor, img_px: Tensor, K: Tensor, dist: Tensor, weights: Tensor,
    refine_iters: int = 10,
) -> tuple[Tensor, Tensor]:
    """Weighted EPnP + Gauss-Newton, finite on any input.

    world (N, 3) or (..., N, 3); img_px (..., N, 2); weights (..., N).
    """
    world = world.expand(*img_px.shape[:-1], 3)
    R0, t0 = epnp(world, _norm_pts(img_px, K, dist), weights)
    R, t = refine_pose(R0, t0, world, img_px, K, dist, weights, iters=refine_iters)
    return _first_finite_pose([(R, t), (R0, t0), _identity_pose(world)])

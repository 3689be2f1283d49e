"""Plain PyTorch landmark and pose stages of the served path: box ->
center / scale (clamped to the crop window), the bilinear crop, the
heatmap decode, and weighted EPnP refined by Gauss-Newton.

The crop and the solve follow the served algorithm step for step (the
same fixed-depth EPnP: Gauss-Jordan inverses, shifted power iterations,
Horn's quaternion alignment, the finite fallbacks), written with exact
float32 products (``mm``) so that no TF32 setting changes them. ``dtype``
lowers the whole solve (the control runs it in bfloat16).
"""

from __future__ import annotations

import torch

PIXEL_STD = 200.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def mm(a, b):
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def center_scale(boxes_xywh, padding, image_size, window):
    """(B, 4) xywh -> centers (B, 2), scales (B, 2), the scale shrunk so
    the square source crop fits the window less 2 px."""
    x, y, w, h = boxes_xywh.to(torch.float32).unbind(-1)
    center = torch.stack([x + w * 0.5, y + h * 0.5], -1)
    scale = torch.stack([w, h], -1) * padding / PIXEL_STD
    if window is not None:
        out_w, out_h = image_size
        smax = min((window[1] - 2) / PIXEL_STD, (window[0] - 2) / PIXEL_STD * (out_w / max(out_h, 1)))
        scale = scale * torch.clamp(smax / torch.clamp(scale[:, :1], min=1e-6), max=1.0)
    return center, scale


def crop_map(center, scale, out_size):
    """(B, 2) a, (B, 2) b of the dst -> src map src = a * dst + b (no rotation)."""
    s = float(out_size[0]) / (scale[..., 0] * PIXEL_STD)
    a = (1.0 / s)[:, None].expand(-1, 2)
    dst_c = torch.tensor([out_size[0] * 0.5, out_size[1] * 0.5], device=center.device)
    return a, center - a * dst_c


def crop(frames, center, scale, out_size):
    """Bilinear crop (zero border) of (B, H, W, 3) uint8 -> (B, OH, OW, 3) float32."""
    b, h, w, _ = frames.shape
    ow, oh = out_size
    a, off = crop_map(center, scale, out_size)
    dev = frames.device
    xs = a[:, 0:1] * torch.arange(ow, dtype=torch.float32, device=dev) + off[:, 0:1]
    ys = a[:, 1:2] * torch.arange(oh, dtype=torch.float32, device=dev) + off[:, 1:2]

    def taps(s, size):
        k = torch.floor(s)[..., None] + torch.tensor([0.0, 1.0], device=dev)
        wt = torch.clamp(1.0 - torch.abs(s[..., None] - k), min=0.0)
        ok = (k >= 0) & (k < size) & ((s > -1.0) & (s < size))[..., None]
        return torch.where(ok, k, 0.0).to(torch.int64), torch.where(ok, wt, 0.0)

    kx, wx = taps(xs, w)
    ky, wy = taps(ys, h)
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    vals = frames[bi, ky[:, :, :, None, None], kx[:, None, None, :, :]].to(torch.float32)
    return ((vals * wx[:, None, None, :, :, None]).sum(-2) * wy[:, :, :, None, None]).sum(2)


def normalize(crops):
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=crops.device) * 255.0
    return (crops - mean) / std


def heatmap_to_frame(center, scale, hm_size):
    """(B, 2) a, b with frame px = a * heatmap cell + b."""
    return crop_map(center, scale, hm_size)


def decode(heatmaps, center, scale):
    """(B, H, W, J) -> keypoints (B, J, 2) in frame px (argmax, the first of
    equals; +-0.25 toward the larger neighbour) and maxvals (B, J)."""
    b, h, w, j = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, j, h * w)
    maxvals = flat.amax(-1)
    idx = torch.argmax(flat, -1)
    coords = torch.stack([(idx % w).float(), torch.floor(idx.float() / w)], -1) * (maxvals > 0)[..., None]
    px, py = torch.floor(coords[..., 0] + 0.5).long(), torch.floor(coords[..., 1] + 0.5).long()
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    pxc, pyc = px.clamp(1, w - 2), py.clamp(1, h - 2)

    def at(dy, dx):
        return torch.gather(flat, -1, ((pyc + dy) * w + pxc + dx)[..., None])[..., 0]

    shift = torch.stack([torch.sign(at(0, 1) - at(0, -1)), torch.sign(at(1, 0) - at(-1, 0))], -1) * 0.25
    coords = coords + shift * ok[..., None]
    a, off = heatmap_to_frame(center, scale, (w, h))
    return coords * a[:, None, :] + off[:, None, :], maxvals


# ------------------------------------------------------------------ PnP

def confidence_mask(conf, init=0.95, decay=0.8, min_count=15, max_iters=100):
    ks = torch.arange(max_iters + 1, dtype=torch.float32, device=conf.device)
    th = init * decay**ks
    meets = (conf[..., None, :] > th[:, None]).sum(-1) >= min_count
    first = torch.argmax(meets.to(torch.int32), -1)
    k = torch.where(meets.any(-1), first, torch.full_like(first, max_iters))
    return conf > th[k][..., None]


def _fro(a):
    return torch.linalg.vector_norm(a, dim=(-2, -1))


def _gj_inverse(A):
    n = A.shape[-1]
    aug = torch.cat([A, torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)], -1)
    for k in range(n):
        piv = aug[..., k, k]
        tiny = torch.where(piv < 0, torch.full_like(piv, -1e-20), torch.full_like(piv, 1e-20))
        piv = torch.where(torch.abs(piv) >= 1e-20, piv, tiny)
        row = aug[..., k, :] / piv[..., None]
        upd = aug - aug[..., :, k, None] * row[..., None, :]
        upd[..., k, :] = row
        aug = upd
    return aug[..., n:]


def _polish(B):
    j = torch.argmax((B * B).sum(-2), -1)
    v = torch.gather(B, -1, j[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    v = mm(B / torch.clamp(_fro(B), min=1e-30)[..., None, None], v[..., None])[..., 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _min_eigvec(A):
    n = A.shape[-1]
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n + 1e-30
    B = _gj_inverse(A + (1e-6 * scale + 1e-12)[..., None, None] * torch.eye(n, dtype=A.dtype, device=A.device))
    for _ in range(3):
        B = B / _fro(B)[..., None, None]
        B = mm(B, B)
    return _polish(B)


def _max_eigvec4(K):
    A = K + _fro(K)[..., None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    for _ in range(7):
        A = A / torch.clamp(_fro(A), min=1e-30)[..., None, None]
        A = mm(A, A)
    return _polish(A)


def _kabsch(world, cam, w):
    wsum = torch.clamp(w.sum(-1), min=1e-8)[..., None]
    mw, mc = (world * w[..., None]).sum(-2) / wsum, (cam * w[..., None]).sum(-2) / wsum
    S = mm(((world - mw[..., None, :]) * w[..., None]).transpose(-1, -2), cam - mc[..., None, :])
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = [[S[..., i, j] for j in range(3)] for i in range(3)]
    rows = [[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]]
    q0, qx, qy, qz = _max_eigvec4(torch.stack([torch.stack(r, -1) for r in rows], -2)).unbind(-1)
    rr = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - q0 * qz), 2 * (qx * qz + q0 * qy)],
          [2 * (qx * qy + q0 * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - q0 * qx)],
          [2 * (qx * qz - q0 * qy), 2 * (qy * qz + q0 * qx), 1 - 2 * (qx * qx + qy * qy)]]
    R = torch.stack([torch.stack(r, -1) for r in rr], -2)
    return R, mc - mm(R, mw[..., None])[..., 0]


_IU, _JU = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)


def epnp(world, img_norm, w):
    n = world.shape[-2]
    wsum = torch.clamp(w.sum(-1), min=1e-8)[..., None]
    c0 = (world * w[..., None]).sum(-2) / wsum
    cen = world - c0[..., None, :]
    var = (cen**2 * w[..., None]).sum(-2) / wsum
    sd = torch.sqrt(torch.maximum(var, torch.clamp(1e-6 * var.amax(-1, keepdim=True), min=1e-10)))
    ctrl = torch.cat([c0[..., None, :], c0[..., None, :] + torch.diag_embed(sd)], -2)
    a123 = cen / sd[..., None, :]
    alpha = torch.cat([(1.0 - a123.sum(-1))[..., None], a123], -1)
    u, v = img_norm[..., 0], img_norm[..., 1]
    sw = torch.sqrt(w)[..., None]
    z = torch.zeros_like(alpha)
    lead = alpha.shape[:-2]
    rx = torch.stack([alpha, z, -alpha * u[..., None]], -1).reshape(*lead, n, 12)
    ry = torch.stack([z, alpha, -alpha * v[..., None]], -1).reshape(*lead, n, 12)
    M = torch.cat([rx * sw, ry * sw], -2)
    x = _min_eigvec(mm(M.transpose(-1, -2), M)).reshape(*lead, 4, 3)
    dc = torch.linalg.vector_norm(ctrl[..., _IU, :] - ctrl[..., _JU, :], dim=-1)
    dv = torch.linalg.vector_norm(x[..., _IU, :] - x[..., _JU, :], dim=-1)
    beta = (dv * dc).sum(-1) / torch.clamp((dv * dv).sum(-1), min=1e-12)
    cam = mm(alpha, beta[..., None, None] * x)
    sign = torch.sign((cam[..., 2] * w).sum(-1) + 1e-12)
    return _kabsch(world, cam * sign[..., None, None], w)


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def _rodrigues(r):
    th = torch.linalg.vector_norm(r, dim=-1)
    big = th > 1e-12
    K = _skew(r / torch.where(big, th, torch.ones_like(th))[..., None])
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    R = eye + torch.sin(th)[..., None, None] * K + (1 - torch.cos(th))[..., None, None] * mm(K, K)
    return torch.where(big[..., None, None], R, eye + _skew(r))


def _project_jacobian(world, R, t, K, dist):
    P = mm(world, R.transpose(-1, -2)) + t[..., None, :]
    X, Y, Z = P.unbind(-1)
    x, y = X / Z, Y / Z
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    drad = k1 + 2 * k2 * r2 + 3 * k3 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    uv = torch.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)
    dxx = rad + 2 * x * x * drad + 2 * p1 * y + 6 * p2 * x
    dxy = 2 * x * y * drad + 2 * p1 * x + 2 * p2 * y
    dyy = rad + 2 * y * y * drad + 6 * p1 * y + 2 * p2 * x
    iz, o = 1.0 / Z, torch.zeros_like(Z)
    dx, dy = torch.stack([iz, o, -x * iz], -1), torch.stack([o, iz, -y * iz], -1)
    du = K[0, 0] * (dxx[..., None] * dx + dxy[..., None] * dy)
    dv = K[1, 1] * (dxy[..., None] * dx + dyy[..., None] * dy)
    J = torch.stack([torch.cat([torch.linalg.cross(P, du, dim=-1), du], -1),
                     torch.cat([torch.linalg.cross(P, dv, dim=-1), dv], -1)], -2)
    return uv, J


def _refine(R, t, world, px, K, dist, w, iters, damping=1e-6):
    lead = R.shape[:-2]
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        uv, J = _project_jacobian(world, R, t, K, dist)
        r = ((uv - px) * w[..., None]).reshape(*lead, -1)
        J = (J * w[..., None, None]).reshape(*lead, -1, 6)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J))
        r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))
        JT = J.transpose(-1, -2)
        delta = -mm(_gj_inverse(mm(JT, J) + damping * eye6), mm(JT, r[..., None]))[..., 0]
        dR = _rodrigues(delta[..., :3])
        Rn, tn = mm(dR, R), mm(dR, t[..., None])[..., 0] + delta[..., 3:]
        ok = torch.isfinite(Rn).all(-1).all(-1) & torch.isfinite(tn).all(-1)
        R, t = torch.where(ok[..., None, None], Rn, R), torch.where(ok[..., None], tn, t)
    return R, t


def _undistort(uv, K, dist, iters=10):
    xy0 = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1]], -1)
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    xy = xy0
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        xy = torch.stack([(xy0[..., 0] - dx) / rad, (xy0[..., 1] - dy) / rad], -1)
    return xy


def solve(world, px, K, dist, w, iters, dtype=torch.float32):
    """Weighted EPnP + ``iters`` Gauss-Newton steps, with the fallbacks
    (refined, then EPnP, then identity one model diameter ahead).
    world (N, 3), px (B, N, 2), w (B, N) -> R (B, 3, 3), t (B, 3) float32."""
    world, px, K, dist, w = (v.to(dtype) for v in (world, px, K, dist, w))
    world = world.expand(*px.shape[:-1], 3)
    R0, t0 = epnp(world, _undistort(px, K, dist), w)
    R, t = _refine(R0, t0, world, px, K, dist, w, iters)
    span = torch.linalg.vector_norm(world - world.mean(-2, keepdim=True), dim=-1).amax(-1)
    zf = torch.clamp(2.0 * span, min=1.0)
    Rf = torch.eye(3, dtype=dtype, device=px.device).expand(*zf.shape, 3, 3)
    tf = torch.stack([torch.zeros_like(zf), torch.zeros_like(zf), zf], -1)
    for Rc, tc in ((R0, t0), (R, t)):
        ok = torch.isfinite(Rc).all(-1).all(-1) & torch.isfinite(tc).all(-1)
        Rf, tf = torch.where(ok[..., None, None], Rc, Rf), torch.where(ok[..., None], tc, tf)
    return Rf.float(), tf.float()

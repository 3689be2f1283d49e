"""Plain PyTorch detector stage of the served path: letterbox, anchors,
proposals (per-level top-k, decode, clip, greedy NMS, global top-k),
windowed multi-level ROIAlign, the box head, Fast R-CNN inference and the
best box of each keyframe.

:func:`keyframe_readout` gives what the correctness check needs: the
reference's best box and score per keyframe, and every pre-NMS proposal of
the RPN decoded and scored by the box head (the candidates against which a
served box is judged).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16)
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
CANDIDATE_WIDEN = 4


def letterbox(frames, size: int):
    """(B, H, W, 3) uint8 -> (B, size, size, 3) float32 (antialiased
    bilinear fit, zero padding bottom and right) and the scale."""
    _, h, w, _ = frames.shape
    scale = size / max(h, w)
    lh, lw = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(frames.to(torch.float32).permute(0, 3, 1, 2), size=(lh, lw), mode="bilinear",
                      align_corners=False, antialias=True)
    return F.pad(x, (0, size - lw, 0, size - lh)).permute(0, 2, 3, 1), scale


def anchors(shape_hw, stride, sizes, ratios, device):
    """(H*W*A, 4) anchors, row-major over (y, x, a), built in float64 as detectron2's generator."""
    base = []
    for s in sizes:
        for r in ratios:
            w = np.sqrt(float(s) ** 2 / r)
            base.append([-w / 2.0, -w * r / 2.0, w / 2.0, w * r / 2.0])
    base = np.asarray(base, np.float32)
    sx, sy = np.meshgrid(np.arange(shape_hw[1]) * stride, np.arange(shape_hw[0]) * stride)
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + base[None]).reshape(-1, 4).astype(np.float32)).to(device)


def box_area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)


def pairwise_iou(a, b):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), torch.zeros_like(inter))


def apply_deltas(d, boxes, weights):
    w, h = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    pcx, pcy = d[..., 0] / weights[0] * w + cx, d[..., 1] / weights[1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2] / weights[2], max=SCALE_CLAMP)) * w
    ph = torch.exp(torch.clamp(d[..., 3] / weights[3], max=SCALE_CLAMP)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def clip(boxes, h, w):
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)


def nonempty(boxes, thresh=0.0):
    return ((boxes[..., 2] - boxes[..., 0]) > thresh) & ((boxes[..., 3] - boxes[..., 1]) > thresh)


def top_k(x, k):
    """Descending, ties to the lowest index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nms_keep(boxes, scores, valid, thresh):
    """Greedy NMS keep-mask over (P, N) problems, visiting boxes by score (stable)."""
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)
    over = torch.triu(pairwise_iou(b, b) > thresh, diagonal=1)
    removed = torch.zeros_like(v)
    for i in range(b.shape[1]):
        removed |= over[:, i] & (v[:, i] & ~removed[:, i])[:, None]
    return torch.zeros_like(v).scatter_(1, order, v & ~removed)


def _axis_taps(coord, limit, origin, win):
    inb = (coord > -1.0) & (coord < limit)
    cc = torch.clamp(coord, 0.0, limit - 1)
    kk = torch.floor(cc)[..., None] + torch.tensor([0.0, 1.0], device=coord.device)
    local = kk - origin[:, None, None].to(torch.float32)
    wt = torch.clamp(1.0 - torch.abs((cc - origin[:, None].to(torch.float32))[..., None] - local), min=0.0)
    ok = inb[..., None] & (local >= 0) & (local < win) & (kk < limit)
    return torch.where(ok, kk, 0.0).to(torch.int64), torch.where(ok, wt, 0.0)


def roi_align(feats, boxes, batch_idx, roi: dict):
    """Multi-level aligned ROIAlign with the box head's per-box read window
    ((window, window + 8) with the x origin rounded down to 8 for the
    ``pallas`` read, (window, window) for ``windowed``). feats: NHWC per
    level p2..p5; boxes (R, 4) -> (R, P, P, C) float32."""
    p, s, win = roi["pooler_resolution"], roi["pooler_sampling_ratio"], roi["pooler_window"]
    pallas = roi["pooler_impl"] == "pallas"
    c = feats[0].shape[-1]
    lvl_min = 2
    target = torch.floor(4 + torch.log2(torch.sqrt(box_area(boxes)) / 224.0 + 1e-8))
    levels = torch.clamp(target, lvl_min, lvl_min + len(feats) - 1).to(torch.int64) - lvl_min
    out = torch.zeros((boxes.shape[0], p, p, c), dtype=torch.float32, device=boxes.device)
    dev = boxes.device
    p_t, s_t = torch.tensor(float(p), device=dev), torch.tensor(float(s), device=dev)
    grid = (torch.arange(p, device=dev)[:, None] + (torch.arange(s, device=dev)[None, :] + 0.5) / s_t).reshape(-1)
    for li, f in enumerate(feats):
        sel = torch.nonzero(levels == li).flatten()
        if sel.numel() == 0:
            continue
        h, w = f.shape[1], f.shape[2]
        wh, ww = win, win + 8 if pallas else win
        x0, y0, x1, y1 = (boxes[sel] * (1.0 / 2 ** (li + 2)) - 0.5).unbind(-1)
        sy = y0[:, None] + grid[None, :] * (y1 - y0)[:, None] / p_t
        sx = x0[:, None] + grid[None, :] * (x1 - x0)[:, None] / p_t
        oy = torch.clamp(torch.floor(y0).to(torch.int64) - 1, 0, max(h - wh, 0))
        ox = torch.clamp(torch.floor(x0).to(torch.int64) - 1, 0, max(w - ww, 0))
        if pallas:
            ox = (ox // 8) * 8
        (ky, wy), (kx, wx) = _axis_taps(sy, h, oy, wh), _axis_taps(sx, w, ox, ww)
        base = batch_idx[sel].to(torch.int64) * (h * w)
        idx = base[:, None, None, None, None] + ky[:, :, :, None, None] * w + kx[:, None, None, :, :]
        vals = f.reshape(-1, c)[idx].to(torch.float32)
        xs = (vals * wx[:, None, None, :, :, None]).sum(-2)
        ys = (xs * wy[:, :, :, None, None]).sum(2)
        out[sel] = ys.reshape(-1, p, s, p, s, c).sum((2, 4)) * (1.0 / (s * s))
    return out


def rpn_candidates(det, pyramid, hw, widen: int = 1):
    """Per level: the top ``widen`` x pre-NMS-k anchors by objectness,
    decoded and clipped. Returns per-level lists of (boxes (B, k, 4),
    scores (B, k), valid (B, k))."""
    cfg, rpn = det.cfg, det.cfg["rpn"]
    head = det.rpn_head(pyramid)
    out = []
    for i, lvl in enumerate(sorted(pyramid)):
        logits, deltas = head[lvl]
        b = logits.shape[0]
        logits, deltas = logits.reshape(b, -1), deltas.reshape(b, -1, 4)
        scores, idx = top_k(logits, min(widen * rpn["pre_nms_topk_test"], logits.shape[1]))
        anc = anchors(pyramid[lvl].shape[2:], STRIDES[lvl], cfg["anchor_sizes"][i], cfg["anchor_aspect_ratios"],
                      logits.device)
        picked = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
        boxes = clip(apply_deltas(picked, anc[idx], rpn["bbox_reg_weights"]), *hw)
        out.append((boxes, scores, nonempty(boxes, rpn["min_size"]) & torch.isfinite(scores)))
    return out


def proposals(det, cands):
    """Per-level NMS, then the global top post-NMS-k (B, P, 4), valid (B, P)."""
    rpn = det.cfg["rpn"]
    kept = []
    for boxes, scores, valid in cands:
        b, k = scores.shape
        keep = nms_keep(boxes.reshape(b, k, 4), scores, valid, rpn["nms_thresh"])
        kept.append(torch.where(keep, scores, torch.full_like(scores, -torch.inf)))
    boxes = torch.cat([c[0] for c in cands], 1)
    masked = torch.cat(kept, 1)
    s, i = top_k(masked, min(rpn["post_nms_topk_test"], masked.shape[1]))
    return torch.gather(boxes, 1, i[..., None].expand(-1, -1, 4)), torch.isfinite(s)


def log_odds(p):
    """The log-odds of a float32 probability, clamped to [1e-7, 1 - 1e-7]:
    how the served and the reference scores are both compared."""
    p = p.to(torch.float32).clamp(1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def box_scores(det, nhwc, props, block=2048):
    """The box head on (B, R, 4) proposals: the fg probability (B, R) as
    the program takes it (a float32 softmax), its :func:`log_odds` (B, R),
    and the class-agnostic decoded boxes (B, R, 4)."""
    roi = det.cfg["roi"]
    b, r = props.shape[:2]
    flat = props.reshape(-1, 4)
    bidx = torch.arange(b, device=props.device).repeat_interleave(r)
    probs, odds, boxes = [], [], []
    for lo in range(0, flat.shape[0], block):
        pooled = roi_align(nhwc, flat[lo:lo + block], bidx[lo:lo + block], roi)
        logits, deltas = det.roi_heads(pooled)
        probs.append(torch.softmax(logits.to(torch.float32), -1)[:, 0])
        odds.append(log_odds(probs[-1]))
        boxes.append(apply_deltas(deltas[:, :4], flat[lo:lo + block], roi["bbox_reg_weights"]))
    return (torch.cat(probs).reshape(b, r), torch.cat(odds).reshape(b, r), torch.cat(boxes).reshape(b, r, 4))


def best_boxes(det, probs, boxes, valid, hw):
    """Fast R-CNN inference for one class (score filter, NMS, top detections)
    and the best box per image, or the whole image when none is left.
    Returns (B, 4) boxes, (B,) their index among the proposals (-1 for the
    whole image)."""
    roi = det.cfg["roi"]
    boxes = clip(boxes, *hw)
    ok = (probs > roi["score_thresh"]) & valid & nonempty(boxes)
    keep = nms_keep(boxes, probs, ok, roi["nms_thresh"])
    masked = torch.where(keep, probs, torch.full_like(probs, -torch.inf))
    s, i = top_k(masked, min(roi["detections_per_image"], masked.shape[1]))
    best = torch.gather(boxes, 1, i[:, :1, None].expand(-1, 1, 4))[:, 0]
    whole = torch.tensor([0.0, 0.0, float(hw[1]), float(hw[0])], device=best.device)
    found = torch.isfinite(s[:, 0])
    return torch.where(found[:, None], best, whole), torch.where(found, i[:, 0], torch.full_like(i[:, 0], -1))


def keyframe_readout(det, lb, feats, served_props=None) -> dict:
    """The reference detector on letterboxed keyframes ``lb`` (B, S, S, 3)
    with trunk features ``feats`` {res2..res5: NCHW}: the best box per
    keyframe and its log-odds, its proposals (B, P, 4; invalid ones empty),
    and the candidates (the top ``CANDIDATE_WIDEN`` x pre-NMS-k anchors of
    each level by objectness, decoded by the RPN and the box head, with
    their log-odds), in letterbox pixels. Where no box is left the whole
    image is the best box, and its log-odds the best candidate's. Given
    another detector's proposals ``served_props`` (B, R, 4), also the box
    head's log-odds of each and its decoded boxes (``served_odds``,
    ``served_boxes``; -inf for an empty proposal)."""
    hw = (lb.shape[1], lb.shape[2])
    pyramid = det.fpn(feats)
    nhwc = [pyramid[lvl].permute(0, 2, 3, 1).contiguous() for lvl in det.cfg["roi"]["in_levels"]]
    props, pvalid = proposals(det, rpn_candidates(det, pyramid, hw))
    probs, odds, boxes = box_scores(det, nhwc, props)
    best, j = best_boxes(det, probs, boxes, pvalid, hw)
    # the candidates reach past each level's pre-NMS cut, where a served proposal may rank otherwise
    cands = rpn_candidates(det, pyramid, hw, CANDIDATE_WIDEN)
    cboxes = torch.cat([c[0] for c in cands], 1)
    cvalid = torch.cat([c[2] for c in cands], 1)
    _, codds, cdec = box_scores(det, nhwc, cboxes)
    codds = torch.where(cvalid, codds, torch.full_like(codds, -torch.inf))
    best_odds = torch.where(j >= 0, torch.gather(odds, 1, j.clamp(min=0)[:, None])[:, 0], codds.amax(1))
    out = {"best": best, "best_odds": best_odds, "props": torch.where(pvalid[..., None], props, 0.0),
           "cand_boxes": clip(cdec, *hw), "cand_odds": codds, "cand_valid": cvalid}
    if served_props is not None:
        _, sodds, sdec = box_scores(det, nhwc, served_props.to(torch.float32))
        out["served_odds"] = torch.where(nonempty(served_props), sodds, torch.full_like(sodds, -torch.inf))
        out["served_boxes"] = clip(sdec, *hw)
    return out

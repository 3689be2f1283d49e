"""Box AP and keypoint-OKS AP (COCOEvaluator's "bbox" and "keypoints" tasks): host-side NumPy.

A copy of the box and keypoint parts of the JAX package's
``data/coco_eval.py`` (``evaluate_detections``, ``box_iou_xyxy``,
``padded_detections_to_list``, ``compute_oks``, ``evaluate_keypoints``
and the matching and AP helpers they call), with pycocotools' COCOeval
semantics: greedy per-image matching of score-sorted detections to ground
truth at each IoU or OKS threshold (0.50:0.05:0.95), 101-point
interpolated precision, the area ranges and a cap of detections an image.
The JAX module's native (ctypes) accelerator and its mask, rotated-box and
segmentation tasks are not copied: the box AP is its numpy backend.
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)

# pycocotools person-keypoint defaults (COCOeval.__init__); used when the
# caller gives no per-keypoint sigmas and J == 17
COCO_PERSON_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]
) / 10.0

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

# the keypoint protocol uses only all / medium / large
KPT_AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _match_image(det_rows, det_scores, gt_rows, iou_thr, area_range, max_dets, iou):
    """Greedy matching of one image's detections at one threshold.

    Rows are packed ``[area, ...]``; ``iou`` is the (D_ordered, G) matrix of
    the score-ordered detections, capped at ``max_dets``. Returns
    (det_matched (D,), det_ignored (D,), their scores, num_gt considered).
    """
    order = np.argsort(-det_scores, kind="stable")[:max_dets]
    det_rows = det_rows[order]
    gt_area = gt_rows[:, 0]
    gt_ignore = (gt_area < area_range[0]) | (gt_area >= area_range[1])
    gt_taken = np.zeros(len(gt_rows), bool)
    matched = np.zeros(len(det_rows), bool)
    ignored = np.zeros(len(det_rows), bool)
    # pycocotools COCOeval.evaluateImg order: gts sorted ignore-last; equal
    # IoU re-matches (the later gt in sorted order wins), and once the
    # running best is a gt that counts the scan stops at the first ignored
    # one: an ignored gt never steals a real match.
    gt_order = np.argsort(gt_ignore, kind="stable")
    for d in range(len(det_rows)):
        best, best_iou = -1, min(iou_thr, 1 - 1e-10)
        for g in gt_order:
            if gt_taken[g]:
                continue
            if best >= 0 and not gt_ignore[best] and gt_ignore[g]:
                break
            if iou[d, g] < best_iou:
                continue
            best, best_iou = g, iou[d, g]
        if best >= 0:
            gt_taken[best] = True
            if gt_ignore[best]:
                ignored[d] = True
            else:
                matched[d] = True
        elif det_rows[d, 0] < area_range[0] or det_rows[d, 0] >= area_range[1]:
            ignored[d] = True  # an unmatched detection outside the area range
    return matched, ignored, det_scores[order], int((~gt_ignore).sum())


def _ap_from_matches(all_matched, all_ignored, all_scores, total_gt):
    """Precision at the 101 recall points -> (AP, max recall)."""
    if total_gt == 0:
        return np.nan, np.nan
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    matched = np.concatenate(all_matched) if all_matched else np.zeros(0, bool)
    ignored = np.concatenate(all_ignored) if all_ignored else np.zeros(0, bool)
    keep = ~ignored
    scores, matched = scores[keep], matched[keep]
    matched = matched[np.argsort(-scores, kind="stable")]
    if len(matched) == 0:
        return 0.0, 0.0
    tp = np.cumsum(matched)
    fp = np.cumsum(~matched)
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1e-12)
    for i in range(len(precision) - 1, 0, -1):  # monotone decreasing
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, REC_THRS, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return prec_at.mean(), recall[-1]


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _box_area(b: np.ndarray) -> np.ndarray:
    return np.prod(np.clip(b[:, 2:4] - b[:, 0:2], 0, None), axis=1)


def evaluate_detections(detections: list[dict], ground_truths: list[dict], max_dets: int = 100) -> dict[str, float]:
    """Box AP of one category.

    detections: per image {"boxes" (D, 4) xyxy, "scores" (D,)};
    ground_truths: per image {"boxes" (G, 4) xyxy}; ``max_dets`` caps the
    detections an image (the reference's training evaluation uses 1,
    ``train_object_detection.py:56``). Returns AP, AP50, AP75, APs, APm,
    APl and AR@max_dets, in percent (NaN where no GT counts).
    """
    if len(detections) != len(ground_truths):
        raise ValueError(f"{len(detections)} detection lists for {len(ground_truths)} images")
    results, ap_per_iou, prepped = {}, {}, []
    for det, gt in zip(detections, ground_truths):  # per-image prep and IoU, out of the 4 x 10 loops
        det_b = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        det_s = np.asarray(det["scores"], np.float64)
        gt_b = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        order = np.argsort(-det_s, kind="stable")[:max_dets]
        prepped.append((_box_area(det_b)[:, None], det_s, _box_area(gt_b)[:, None], box_iou_xyxy(det_b[order], gt_b)))
    for area_name, area_range in AREA_RANGES.items():
        aps, ars = [], []
        for t in IOU_THRS:
            all_matched, all_ignored, all_scores, total_gt = [], [], [], 0
            for det_rows, det_s, gt_rows, iou in prepped:
                m, ig, sc, ng = _match_image(det_rows, det_s, gt_rows, t, area_range, max_dets, iou)
                all_matched.append(m)
                all_ignored.append(ig)
                all_scores.append(sc)
                total_gt += ng
            ap, ar = _ap_from_matches(all_matched, all_ignored, all_scores, total_gt)
            aps.append(ap)
            ars.append(ar)
            if area_name == "all":
                ap_per_iou[round(float(t), 2)] = ap
        key = {"all": "AP", "small": "APs", "medium": "APm", "large": "APl"}[area_name]
        results[key] = float(np.nanmean(aps)) * 100 if not np.all(np.isnan(aps)) else float("nan")
        if area_name == "all":
            results["AR"] = float(np.nanmean(ars)) * 100 if not np.all(np.isnan(ars)) else float("nan")
    results["AP50"] = ap_per_iou.get(0.5, np.nan) * 100
    results["AP75"] = ap_per_iou.get(0.75, np.nan) * 100
    return results


def padded_detections_to_list(dets: dict) -> list[dict]:
    """The detector's padded outputs (B, K, ...) with ``valid`` -> per-image
    {"boxes", "scores"} numpy lists of the valid ones."""
    to_np = lambda x: x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    boxes, scores, valid = (to_np(dets[k]) for k in ("boxes", "scores", "valid"))
    return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]]} for i in range(boxes.shape[0])]


def compute_oks(det_kps: np.ndarray, gt_kps: np.ndarray, gt_areas: np.ndarray, gt_boxes: np.ndarray,
                sigmas: np.ndarray) -> np.ndarray:
    """Object-keypoint-similarity matrix (pycocotools computeOks).

    det_kps (D, J, 3) [x, y, score]; gt_kps (G, J, 3) [x, y, vis];
    gt_areas (G,); gt_boxes (G, 4) xywh. The mean over labeled keypoints of
    exp(-d^2 / (2 area sigma_i^2)); for a gt with no labeled keypoint,
    distances are measured to its box expanded 2x and every keypoint
    counts.
    """
    D, G = len(det_kps), len(gt_kps)
    ious = np.zeros((D, G))
    if D == 0 or G == 0:
        return ious
    var = (2.0 * np.asarray(sigmas)) ** 2
    for j in range(G):
        xg, yg, vg = gt_kps[j, :, 0], gt_kps[j, :, 1], gt_kps[j, :, 2]
        k1 = int((vg > 0).sum())
        x0 = gt_boxes[j, 0] - gt_boxes[j, 2]
        x1 = gt_boxes[j, 0] + gt_boxes[j, 2] * 2
        y0 = gt_boxes[j, 1] - gt_boxes[j, 3]
        y1 = gt_boxes[j, 1] + gt_boxes[j, 3] * 2
        for i in range(D):
            xd, yd = det_kps[i, :, 0], det_kps[i, :, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0.0, x0 - xd) + np.maximum(0.0, xd - x1)
                dy = np.maximum(0.0, y0 - yd) + np.maximum(0.0, yd - y1)
            e = (dx**2 + dy**2) / var / (gt_areas[j] + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = float(np.sum(np.exp(-e)) / e.shape[0])
    return ious


def evaluate_keypoints(detections: list[dict], ground_truths: list[dict], sigmas: np.ndarray | None = None,
                       max_dets: int = 20) -> dict[str, float]:
    """Keypoint-OKS AP: {AP, APm, APl, AR, AP50, AP75}, in percent.

    detections: per image {"keypoints" (D, J, 3), "scores" (D,)};
    ground_truths: per image {"keypoints" (G, J, 3) with vis in column 2,
    "boxes" (G, 4) xywh, optional "areas" (G,), by default w * h}.
    ``sigmas`` default to the COCO-person 17 when J == 17, else 0.05 each.
    A gt with no labeled keypoint is ignored, as one outside the area range.
    """
    if len(detections) != len(ground_truths):
        raise ValueError(f"{len(detections)} images of detections, {len(ground_truths)} of ground truth")
    prepped = []
    for det, gt in zip(detections, ground_truths):
        det_kps = np.asarray(det["keypoints"], np.float64)
        det_kps = det_kps.reshape((-1,) + tuple(det_kps.shape[1:])) if det_kps.size else np.zeros((0, 1, 3))
        det_s = np.asarray(det["scores"], np.float64)
        gt_kps = np.asarray(gt["keypoints"], np.float64)
        gt_kps = (gt_kps.reshape((-1,) + tuple(gt_kps.shape[1:])) if gt_kps.size
                  else np.zeros((0, det_kps.shape[1] if len(det_kps) else 1, 3)))
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        jj = det_kps.shape[1] if len(det_kps) else gt_kps.shape[1]
        if sigmas is None:
            sg = COCO_PERSON_SIGMAS if jj == 17 else np.full(jj, 0.05)
        else:
            sg = np.asarray(sigmas, np.float64)
        gt_areas = np.asarray(gt.get("areas", gt_boxes[:, 2] * gt_boxes[:, 3]), np.float64)
        # rows [area, ...]: a gt with no labeled keypoint gets area -1, outside
        # every range; a detection's area is its keypoints' bounding box's
        n_vis = (gt_kps[:, :, 2] > 0).sum(axis=1) if len(gt_kps) else np.zeros(0)
        gt_eff_area = np.where(n_vis > 0, gt_areas, -1.0)
        if len(det_kps):
            dw = det_kps[:, :, 0].max(1) - det_kps[:, :, 0].min(1)
            dh = det_kps[:, :, 1].max(1) - det_kps[:, :, 1].min(1)
            dpack = np.concatenate([(dw * dh)[:, None], det_kps.reshape(len(det_kps), -1)], axis=1)
        else:
            dpack = np.zeros((0, 1 + jj * 3))
        gpack = (np.concatenate([gt_eff_area[:, None], gt_areas[:, None], gt_boxes,
                                 gt_kps.reshape(len(gt_kps), -1)], axis=1)
                 if len(gt_kps) else np.zeros((0, 2 + 4 + jj * 3)))
        dp = dpack[np.argsort(-det_s, kind="stable")[:max_dets]]
        if len(dp) == 0 or len(gpack) == 0:
            iou = np.zeros((len(dp), len(gpack)))
        else:  # the true area for OKS, even on ignored gts
            iou = compute_oks(dp[:, 1:].reshape(len(dp), jj, 3), gpack[:, 6:].reshape(len(gpack), jj, 3),
                              gpack[:, 1], gpack[:, 2:6], sg)
        prepped.append((dpack, det_s, gpack, iou))

    results, ap_per_iou = {}, {}
    for area_name, area_range in KPT_AREA_RANGES.items():
        aps, ars = [], []
        for t in IOU_THRS:
            all_matched, all_ignored, all_scores, total_gt = [], [], [], 0
            for dpack, det_s, gpack, iou in prepped:
                m, ig, sc, ng = _match_image(dpack, det_s, gpack, t, area_range, max_dets, iou)
                all_matched.append(m)
                all_ignored.append(ig)
                all_scores.append(sc)
                total_gt += ng
            ap, ar = _ap_from_matches(all_matched, all_ignored, all_scores, total_gt)
            aps.append(ap)
            ars.append(ar)
            if area_name == "all":
                ap_per_iou[round(float(t), 2)] = ap
        key = {"all": "AP", "medium": "APm", "large": "APl"}[area_name]
        results[key] = float(np.nanmean(aps)) * 100 if not np.all(np.isnan(aps)) else float("nan")
        if area_name == "all":
            results["AR"] = float(np.nanmean(ars)) * 100 if not np.all(np.isnan(ars)) else float("nan")
    results["AP50"] = ap_per_iou.get(0.5, np.nan) * 100
    results["AP75"] = ap_per_iou.get(0.75, np.nan) * 100
    return results

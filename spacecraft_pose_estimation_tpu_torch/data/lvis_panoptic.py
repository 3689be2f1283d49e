"""LVIS detection AP and panoptic quality (PQ) (port of ``data/lvis_panoptic.py``).

A copy of the JAX package's numpy evaluators (detectron2's
``evaluation/lvis_evaluation.py``, which defers to the ``lvis`` package's
LVISEval, and ``evaluation/panoptic_evaluation.py``, which defers to
``panopticapi.evaluation.pq_compute``; neither package is needed):

* LVIS AP (Gupta et al., CVPR 2019): per-category 101-point AP over IoU
  0.50:0.95, where a category counts only on images that annotate it
  exhaustively (it is in the GT) or verify it absent (``neg_classes``):
  its detections on other images are ignored, not false positives; AP
  also for the rare (<= 10 training images), common (11-100) and frequent
  (> 100) bins. Detections are capped at ``max_dets`` an image across
  categories, by score (LVIS default 300).
* Panoptic quality (Kirillov et al., CVPR 2019): segments match iff of one
  category with IoU > 0.5; PQ = sum(IoU of TPs) / (TP + FP/2 + FN/2),
  SQ = sum(IoU) / TP, RQ = TP / (TP + FP/2 + FN/2), averaged over the
  categories with any TP, FP or FN, plus the thing / stuff splits. VOID as
  in panopticapi: a prediction's overlap with GT void leaves its union, a
  prediction over 50% void or crowd is no false positive, and crowd GT
  segments neither match nor count as false negatives.
"""

from __future__ import annotations

import numpy as np

from .coco_eval import AREA_RANGES, IOU_THRS, _ap_from_matches, _box_area, _match_image, box_iou_xyxy

__all__ = ["evaluate_lvis", "evaluate_panoptic", "lvis_frequency_bins"]


def lvis_frequency_bins(category_image_counts: dict) -> dict:
    """category -> 'r' | 'c' | 'f' from training-set image counts
    (LVIS v1 protocol: rare <= 10 images, common 11-100, frequent > 100)."""
    bins = {}
    for cat, n in category_image_counts.items():
        bins[cat] = "r" if n <= 10 else ("c" if n <= 100 else "f")
    return bins


def _match_boxes(det_b, det_s, gt_b, iou_thr, area_range, max_dets):
    """``coco_eval._match_image`` on XYXY boxes: their areas and the IoU of
    the score-ordered, capped detections."""
    order = np.argsort(-det_s, kind="stable")[:max_dets]
    return _match_image(_box_area(det_b)[:, None], det_s, _box_area(gt_b)[:, None], iou_thr, area_range, max_dets,
                        box_iou_xyxy(det_b[order], gt_b))


def _cap_dets(det: dict, max_dets: int) -> dict:
    scores = np.asarray(det.get("scores", []), np.float64)
    if len(scores) <= max_dets:
        return det
    keep = np.argsort(-scores, kind="stable")[:max_dets]
    return {
        "boxes": np.asarray(det["boxes"], np.float64).reshape(-1, 4)[keep],
        "scores": scores[keep],
        "classes": np.asarray(det["classes"])[keep],
    }


def evaluate_lvis(
    detections: list[dict],
    ground_truths: list[dict],
    category_image_counts: dict | None = None,
    max_dets: int = 300,
) -> dict[str, float]:
    """LVIS-protocol AP over multi-category detections.

    Args:
      detections: per image {"boxes" (D,4) xyxy, "scores" (D,),
        "classes" (D,) int}.
      ground_truths: per image {"boxes" (G,4) xyxy, "classes" (G,) int,
        "neg_classes" (optional list[int]): categories verified absent}.
      category_image_counts: category -> #training images (drives the
        r/c/f frequency bins; omit to skip APr/APc/APf).
      max_dets: per-image cap across categories (LVIS default 300; the
        reference's LVISEvaluator exposes it as max_dets_per_image).

    Returns: AP, AP50, AP75, APs, APm, APl (+ APr, APc, APf when
    frequency data is given). All values in percent; NaN when undefined.
    """
    assert len(detections) == len(ground_truths)
    detections = [_cap_dets(d, max_dets) for d in detections]
    cats = sorted(
        {int(c) for gt in ground_truths for c in np.asarray(gt.get("classes", []))}
    )
    freq = (
        lvis_frequency_bins(category_image_counts)
        if category_image_counts is not None
        else None
    )

    # per (category, area, iou) AP via the shared matcher
    per_cat: dict[int, dict[str, list[float]]] = {}
    for cat in cats:
        per_area: dict[str, list[float]] = {}
        for area_name, area_range in AREA_RANGES.items():
            aps = []
            for t in IOU_THRS:
                all_m, all_ig, all_sc = [], [], []
                total_gt = 0
                for det, gt in zip(detections, ground_truths):
                    gt_cls = np.asarray(gt.get("classes", []), int)
                    gt_sel = gt_cls == cat
                    pos = bool(gt_sel.any())
                    neg = cat in set(int(c) for c in gt.get("neg_classes", []))
                    if not (pos or neg):
                        # not exhaustively annotated for this category:
                        # detections here are IGNORED (the LVIS rule)
                        continue
                    det_cls = np.asarray(det.get("classes", []), int)
                    det_sel = det_cls == cat
                    m, ig, sc, ng = _match_boxes(
                        np.asarray(det["boxes"], np.float64).reshape(-1, 4)[det_sel],
                        np.asarray(det["scores"], np.float64)[det_sel],
                        np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[gt_sel],
                        t,
                        area_range,
                        max_dets,
                    )
                    all_m.append(m)
                    all_ig.append(ig)
                    all_sc.append(sc)
                    total_gt += ng
                ap, _ = _ap_from_matches(all_m, all_ig, all_sc, total_gt)
                aps.append(ap)
            per_area[area_name] = aps
        per_cat[cat] = per_area

    def mean_ap(cat_subset, area_name="all", iou_idx=None):
        vals = []
        for cat in cat_subset:
            aps = np.asarray(per_cat[cat][area_name], np.float64)
            if iou_idx is not None:
                v = aps[iou_idx]
            else:
                v = np.nan if np.all(np.isnan(aps)) else np.nanmean(aps)
            vals.append(v)
        vals = np.asarray(vals, np.float64)
        return float(np.nanmean(vals)) * 100 if len(vals) and not np.all(np.isnan(vals)) else float("nan")

    results = {
        "AP": mean_ap(cats),
        "AP50": mean_ap(cats, iou_idx=int(np.argmin(np.abs(IOU_THRS - 0.5)))),
        "AP75": mean_ap(cats, iou_idx=int(np.argmin(np.abs(IOU_THRS - 0.75)))),
        "APs": mean_ap(cats, "small"),
        "APm": mean_ap(cats, "medium"),
        "APl": mean_ap(cats, "large"),
    }
    if freq is not None:
        for b, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
            subset = [c for c in cats if freq.get(c) == b]
            results[key] = mean_ap(subset) if subset else float("nan")
    return results


# ---------------------------------------------------------------------------
# Panoptic quality
# ---------------------------------------------------------------------------


def _segment_areas(seg_map: np.ndarray) -> dict[int, int]:
    ids, counts = np.unique(seg_map, return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts)}


def evaluate_panoptic(
    predictions: list[tuple],
    ground_truths: list[tuple],
    thing_categories: set | None = None,
    void: int = 0,
) -> dict[str, float]:
    """Panoptic quality over a list of images.

    Args:
      predictions: per image (seg_map (H,W) int segment ids,
        segments: list of {"id", "category"}).
      ground_truths: per image (seg_map, segments: list of
        {"id", "category", "iscrowd" (optional)}). Pixels with seg id
        ``void`` belong to no segment.
      thing_categories: category ids counted as things (for the
        PQ_th/PQ_st split; omit for overall only).
      void: the segment id marking unlabeled pixels.

    Returns {PQ, SQ, RQ, N, PQ_th, SQ_th, RQ_th, N_th, PQ_st, ...} —
    percentages except the N counts; panopticapi pq_compute semantics.
    """
    stats: dict[int, dict[str, float]] = {}  # cat -> tp/fp/fn/iou_sum

    def st(cat):
        return stats.setdefault(cat, {"tp": 0, "fp": 0, "fn": 0, "iou": 0.0})

    for (pred_map, pred_segs), (gt_map, gt_segs) in zip(predictions, ground_truths):
        pred_map = np.asarray(pred_map)
        gt_map = np.asarray(gt_map)
        assert pred_map.shape == gt_map.shape
        pred_cat = {int(s["id"]): int(s["category"]) for s in pred_segs}
        gt_cat = {int(s["id"]): int(s["category"]) for s in gt_segs}
        gt_crowd = {int(s["id"]) for s in gt_segs if s.get("iscrowd")}
        pred_areas = _segment_areas(pred_map)
        gt_areas = _segment_areas(gt_map)
        # pair intersections through a combined 64-bit key
        offset = np.int64(1) << 32
        comb = gt_map.astype(np.int64) * offset + pred_map.astype(np.int64)
        keys, counts = np.unique(comb, return_counts=True)
        inter: dict[tuple[int, int], int] = {}
        for k, c in zip(keys, counts):
            inter[(int(k // offset), int(k % offset))] = int(c)

        matched_gt: set[int] = set()
        matched_pred: set[int] = set()
        for (gid, pid), i_area in inter.items():
            if gid == void or pid == void:
                continue
            if gid in gt_crowd:
                continue
            if gt_cat.get(gid) != pred_cat.get(pid):
                continue
            union = (
                gt_areas[gid]
                + pred_areas[pid]
                - i_area
                - inter.get((void, pid), 0)  # pred's void part leaves the union
            )
            iou = i_area / union if union > 0 else 0.0
            if iou > 0.5:
                s = st(gt_cat[gid])
                s["tp"] += 1
                s["iou"] += iou
                matched_gt.add(gid)
                matched_pred.add(pid)

        for gid, cat in gt_cat.items():
            if gid in matched_gt or gid in gt_crowd or gid == void:
                continue
            st(cat)["fn"] += 1

        # crowd pixels per category (same-class crowd overlap excuses a pred)
        crowd_by_cat: dict[int, set[int]] = {}
        for gid in gt_crowd:
            crowd_by_cat.setdefault(gt_cat[gid], set()).add(gid)
        for pid, cat in pred_cat.items():
            if pid in matched_pred or pid == void:
                continue
            ignored = inter.get((void, pid), 0)
            for gid in crowd_by_cat.get(cat, ()):
                ignored += inter.get((gid, pid), 0)
            if pred_areas.get(pid, 0) and ignored / pred_areas[pid] > 0.5:
                continue  # mostly void/crowd: not a false positive
            st(cat)["fp"] += 1

    def summarize(cat_subset, suffix=""):
        pqs, sqs, rqs, n = [], [], [], 0
        for cat in cat_subset:
            s = stats[cat]
            if s["tp"] + s["fp"] + s["fn"] == 0:
                continue
            n += 1
            denom = s["tp"] + 0.5 * s["fp"] + 0.5 * s["fn"]
            pqs.append(s["iou"] / denom)
            sqs.append(s["iou"] / s["tp"] if s["tp"] else 0.0)
            rqs.append(s["tp"] / denom)
        out = {}
        for name, vals in (("PQ", pqs), ("SQ", sqs), ("RQ", rqs)):
            out[name + suffix] = float(np.mean(vals)) * 100 if vals else float("nan")
        out["N" + suffix] = n
        return out

    results = summarize(sorted(stats))
    if thing_categories is not None:
        things = [c for c in sorted(stats) if c in thing_categories]
        stuff = [c for c in sorted(stats) if c not in thing_categories]
        results.update(summarize(things, "_th"))
        results.update(summarize(stuff, "_st"))
    return results

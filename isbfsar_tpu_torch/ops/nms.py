"""Detection postprocessing (port of ``isbfsar_tpu/ops/nms.py``), batched
over a leading frame axis.

- :func:`best_person_box`, the pipeline's path: greedy NMS never
  suppresses the top-scoring box, so the highest-confidence person box is
  a plain argmax over the person-class confidences.
- :func:`postprocess_yolo`, the reference's full postprocessing: the
  person candidates above the threshold, the top ``max_det`` by score
  (ties to the lower index, as ``jax.lax.top_k``), then greedy IoU NMS
  over them as ``max_det`` sequential steps of device ops that never wait
  for the host (the JAX ``fori_loop``), padded to fixed shapes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., n, 4) [x1, y1, x2, y2] boxes -> (..., n, n)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(xx2 - xx1, min=0.0) * torch.clamp(yy2 - yy1, min=0.0)
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter / union


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_thresh: float = 0.7) -> torch.Tensor:
    """Greedy NMS over fixed-size candidate sets sorted by descending score
    (:func:`top_candidates`): boxes (B, n, 4), scores (B, n), valid (B, n)
    bool -> (B, n) keep mask. A box is kept iff it is valid and no kept
    box before it overlaps it with IoU > ``iou_thresh`` (the reference's
    ``nms_cpu``)."""
    n = boxes.shape[-2]
    iou = iou_matrix(boxes)
    earlier = torch.arange(n, device=boxes.device)
    keep = torch.zeros(valid.shape, dtype=torch.bool, device=boxes.device)
    for i in range(n):
        suppressed = ((iou[:, i] > iou_thresh) & keep & (earlier < i)).any(dim=-1)
        keep[:, i:i + 1] = (valid[:, i] & ~suppressed)[:, None]
    return keep


def top_candidates(boxes: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-``k`` scored boxes under ``mask``, in descending order with
    ties to the lower index: boxes (B, n, 4), scores and mask (B, n) ->
    (boxes (B, k, 4), scores (B, k), valid (B, k))."""
    masked = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    # a stable descending sort keeps tied scores in index order, as top_k
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    picked = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    return picked, top, torch.isfinite(top)


def postprocess_yolo(boxes: torch.Tensor, confidences: torch.Tensor, conf_thresh: float = 0.3,
                     nms_thresh: float = 0.7, max_det: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """YOLO outputs -> padded person detections (reference misc.py:64-107).

    boxes (B, N, 1, 4) or (B, N, 4) normalized [x1, y1, x2, y2];
    confidences (B, N, C). Each anchor takes its best class; anchors whose
    best class is the person (0) above ``conf_thresh`` are candidates.
    Returns (detections (B, max_det, 6) [x1, y1, x2, y2, conf, cls] with
    conf 0 on padding, keep (B, max_det) bool)."""
    b = confidences.shape[0]
    boxes = boxes.reshape(b, -1, 4)
    confidences = confidences.reshape(b, boxes.shape[1], -1)
    max_conf, max_id = confidences.max(dim=2)
    person = (max_conf > conf_thresh) & (max_id == 0)
    cand_boxes, cand_scores, cand_valid = top_candidates(boxes, max_conf, person, max_det)
    keep = nms_fixed(cand_boxes, cand_scores, cand_valid, nms_thresh)
    dets = torch.cat([cand_boxes,
                      torch.where(cand_valid, cand_scores, torch.zeros_like(cand_scores))[..., None],
                      torch.zeros_like(cand_scores)[..., None]], dim=-1)
    return dets, keep


def best_person_box(boxes: torch.Tensor, confidences: torch.Tensor, conf_thresh: float = 0.3):
    """boxes (B, N, 1, 4) or (B, N, 4) normalized x1y1x2y2; confidences (B, N, C).

    Returns (box (B, 4), conf (B,) zeroed where not found, found (B,) bool).
    """
    b = confidences.shape[0]
    boxes = boxes.reshape(b, -1, 4)
    confidences = confidences.reshape(b, boxes.shape[1], -1)
    max_conf, max_id = confidences.max(dim=2)
    person_conf = torch.where(max_id == 0, max_conf, torch.full_like(max_conf, -torch.inf))
    best = person_conf.argmax(dim=1)
    conf = person_conf.gather(1, best[:, None])[:, 0]
    found = conf > conf_thresh
    box = boxes[torch.arange(b, device=boxes.device), best]
    return box, torch.where(found, conf, torch.zeros_like(conf)), found

"""Person-box selection (port of ``isbfsar_tpu/ops/nms.py::best_person_box``).

The pipeline keeps only the highest-confidence person box; greedy NMS never
suppresses the top-scoring box, so the choice is a plain argmax over the
person-class confidences.
"""

from __future__ import annotations

import torch


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

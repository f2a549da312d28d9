"""Head-detector training (port of ``isbfsar_tpu/train/detection.py``):
Pascal-VOC head boxes, the single-stage detection loss and the trainer.

Assignment, per image: each valid ground-truth box's highest-IoU
prediction is positive (ties to the lower index, as ``jnp.argmax``), a
prediction under ``neg_iou`` to every ground truth and not positive is
negative, the rest are ignored; padding ground truths (``valid`` False)
mark nothing. Loss: binary cross-entropy on the scores over positives and
negatives, plus smooth-L1 on the matched boxes of the valid ground truths.

:class:`DetectorTrainer` trains ``HeadDetectorNet`` with JAX's optimizer
(clip 1.0, Adam) and batch statistics; the trunk's running averages move
by Flax's default momentum 0.99, after the update. It runs on ``device``
(the card unless the caller asks for ``"cpu"``), in float32 with TF32 off
for float32 work. :class:`VOCHeadDataset` reads ``.jpg`` files, which needs
cv2: it is imported where the image is read, and the card drives the
trainer through :meth:`DetectorTrainer.train_step` on batches in memory.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isbfsar_tpu_torch.configs import MutualGazeConfig
from isbfsar_tpu_torch.models.detection import HeadDetectorNet
from isbfsar_tpu_torch.train.posestack import NetTrainer, pairwise_iou, smooth_l1


class VOCHeadDataset:
    """Pascal-VOC XML head boxes (SCUT-HEAD layout: JPEGImages/ +
    Annotations/*.xml). Items: {"image": (s, s, 3) RGB float32 in [0, 1],
    "boxes": (max_boxes, 4) normalized x1y1x2y2, zero-padded, "valid":
    (max_boxes,) bool}."""

    def __init__(self, root: str, image_size: int = 256, max_boxes: int = 16):
        self.root = root
        self.image_size = image_size
        self.max_boxes = max_boxes
        ann_dir = os.path.join(root, "Annotations")
        self.ids = sorted(os.path.splitext(f)[0] for f in os.listdir(ann_dir) if f.endswith(".xml"))

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        import cv2  # JPEG decoding; the port's own codec reads PNG only

        name = self.ids[i]
        root = ET.parse(os.path.join(self.root, "Annotations", f"{name}.xml")).getroot()
        size = root.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        boxes = []
        for obj in root.findall("object"):
            bb = obj.find("bndbox")
            boxes.append([float(bb.find("xmin").text) / w, float(bb.find("ymin").text) / h,
                          float(bb.find("xmax").text) / w, float(bb.find("ymax").text) / h])
        boxes = np.asarray(boxes[: self.max_boxes], np.float32).reshape(-1, 4)
        padded = np.zeros((self.max_boxes, 4), np.float32)
        padded[: len(boxes)] = boxes
        valid = np.zeros(self.max_boxes, bool)
        valid[: len(boxes)] = True
        img = cv2.imread(os.path.join(self.root, "JPEGImages", f"{name}.jpg"))
        img = cv2.resize(img, (self.image_size, self.image_size))
        return {"image": (img[..., ::-1] / 255.0).astype(np.float32), "boxes": padded,
                "valid": valid}


def detection_loss(pred_boxes: torch.Tensor, pred_scores: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, neg_iou: float = 0.3
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """JAX's single-image loss, batched: pred (b, n, 4) / (b, n), gt (b, m, 4)
    with (b, m) validity -> (per-image totals (b,), {score_loss, box_loss}).

    The positives are a one-hot over n + 1 slots, each ground truth's best
    prediction or, for a padding one, slot n (then dropped): no scatter,
    so no write order to depend on (JAX routes padding to an index its
    scatter drops, for the same reason)."""
    b, n = pred_scores.shape
    valid = gt_valid.bool()
    iou = torch.where(valid[:, None, :], pairwise_iou(pred_boxes, gt_boxes), -1.0)  # (b, n, m)
    best_pred = torch.argmax(iou, dim=1)  # (b, m), the first of ties
    slot = torch.where(valid, best_pred, n)
    pos = F.one_hot(slot, n + 1)[..., :n].any(dim=1)  # (b, n)
    neg = (iou.max(dim=2).values < neg_iou) & ~pos
    p = torch.clamp(pred_scores, 1e-6, 1 - 1e-6)
    count = (pos.sum(1) + neg.sum(1)).to(p.dtype)
    score_loss = -((torch.log(p) * pos).sum(1) + (torch.log(1 - p) * neg).sum(1)) / torch.clamp(
        count, min=1.0)
    matched = torch.gather(pred_boxes, 1, best_pred[..., None].expand(-1, -1, 4))  # (b, m, 4)
    box_loss = (smooth_l1(matched - gt_boxes) * valid[..., None]).sum((1, 2)) / torch.clamp(
        valid.sum(1).to(p.dtype) * 4, min=1.0)
    return score_loss + box_loss, {"score_loss": score_loss, "box_loss": box_loss}


class DetectorTrainer(NetTrainer):
    """batch: {"image": (b, s, s, 3) RGB in [0, 1], "boxes": (b, m, 4),
    "valid": (b, m) bool}, numpy or tensors. ``dtype``: the net's compute
    type (bf16 as JAX's; float32 or float64 to hold it to JAX in those), the
    parameters float32 whatever it is, as Flax's."""

    def __init__(self, config: MutualGazeConfig, input_size: int = 256, seed: int = 0,
                 lr: float = 1e-4, dtype: torch.dtype = torch.bfloat16,
                 variables: Optional[Mapping] = None, device: str = "cuda"):
        self.config = config
        self.input_size = input_size
        super().__init__(HeadDetectorNet(dtype), variables, "detector", seed, lr, device)

    def loss(self, batch: Mapping, stats: Optional[list] = None) -> torch.Tensor:
        image = torch.as_tensor(batch["image"]).to(self.device).permute(0, 3, 1, 2)
        boxes, scores = self.net(image, True, stats)
        losses, _ = detection_loss(boxes, scores, torch.as_tensor(batch["boxes"]).to(self.device),
                                   torch.as_tensor(batch["valid"]).to(self.device))
        return losses.mean()

    def fit(self, dataset, n_epochs: int = 1, batch_size: int = 4) -> List[float]:
        losses = []
        for _ in range(n_epochs):
            for i in range(0, len(dataset) - batch_size + 1, batch_size):
                items = [dataset[j] for j in range(i, i + batch_size)]
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                losses.append(self.train_step(batch))
        return losses

"""Mutual-gaze ("is looking at me") classifier training and evaluation
(port of ``isbfsar_tpu/train/mutualgaze.py``).

:class:`WatchingDataset` reads ``root/<session>/<label 0|1>/*.png`` crops
with the port's PNG codec (``utils/png.py``, bit-exact to ``cv2.imread``)
and resizes them with ``ops/image.py::resize_linear_u8`` (cv2's
``INTER_LINEAR``), so it runs without cv2. :class:`MutualGazeTrainer`: a
ResNet-18 or ResNet-50 ("mobilenet" -> ResNet-18) and
``BinaryGazeClassifier``, binary cross-entropy, plain Adam at
``config.lr`` (``train/optim.py`` without the clip), batch statistics in
training with running averages at momentum 0.9; leave-one-session-out
cross-validation with a fresh model a fold (``reset(fold)``) and best-F1
checkpoints in JAX's layout, which either package reads
(``utils/checkpoint.py``). :func:`evaluate_gaze_heuristic` scores a focus
detector over annotated frames.

The trainer runs on ``device`` (the card unless the caller asks for
``"cpu"``; float32 work with TF32 off). The port's seeded init is not
JAX's: parity checks hand :meth:`MutualGazeTrainer.reset` JAX's init.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import MutualGazeConfig
from isbfsar_tpu_torch.focus.mutual import backbone_for
from isbfsar_tpu_torch.models.detection import BinaryGazeClassifier
from isbfsar_tpu_torch.models.layers import float32_device, init_random, update_running_stats
from isbfsar_tpu_torch.ops.image import resize_linear_u8
from isbfsar_tpu_torch.train.optim import ClipAdam
from isbfsar_tpu_torch.utils import checkpoint as ckpt
from isbfsar_tpu_torch.utils.metrics import MetricsLogger, binary_prf
from isbfsar_tpu_torch.utils.png import read_png
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables


class WatchingDataset:
    """Directory-of-crops dataset: root/<session>/<label 0|1>/*.png. Items:
    ((s, s, 3) RGB float32 in [0, 1], label)."""

    def __init__(self, root: str, sessions: Optional[List[str]] = None, crop_size: int = 224):
        self.crop_size = crop_size
        self.items: List[Tuple[str, int]] = []
        for session in sessions or sorted(os.listdir(root)):
            for label in ("0", "1"):
                d = os.path.join(root, session, label)
                if not os.path.isdir(d):
                    continue
                for f in sorted(os.listdir(d)):
                    self.items.append((os.path.join(d, f), int(label)))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[i]
        img = resize_linear_u8(read_png(path), self.crop_size, self.crop_size)
        return (img[..., ::-1] / 255.0).astype(np.float32), label


def augment_flip(img: np.ndarray, label: int, rng: np.random.Generator):
    """Horizontal flip with probability 0.5 (one draw); the label stays."""
    if rng.random() < 0.5:
        return img[:, ::-1].copy(), label
    return img, label


def session_splits(sessions: List[str]) -> Iterator[Tuple[List[str], List[str]]]:
    """Leave-one-session-out cross-validation splits."""
    for held in sessions:
        yield [s for s in sessions if s != held], [held]


class MutualGazeTrainer:
    def __init__(self, config: MutualGazeConfig, seed: int = 0, log_dir: str = "runs/mutualgaze",
                 device: str = "cuda", dtype: torch.dtype = torch.bfloat16):
        """dtype: the backbone's compute type (bf16 as JAX's; float32 or
        float64 to hold it to JAX), the parameters float32 whatever it is."""
        self.config = config
        self.device = float32_device(device)
        self.dtype = dtype
        self.logger = MetricsLogger(log_dir, use_wandb=False)
        self.reset(seed)

    def reset(self, seed: int = 0, variables: Optional[Mapping] = None) -> None:
        """A new model and a fresh optimizer: random weights from ``seed``,
        or ``variables`` in JAX's layout ({"params": {"backbone", "head"},
        "batch_stats": {"backbone"}})."""
        self.backbone, feat_dim = backbone_for(self.config.backbone, self.dtype)
        self.head = BinaryGazeClassifier(feat_dim)
        if variables is None:
            gen = torch.Generator().manual_seed(seed)
            init_random(self.backbone, gen)
            init_random(self.head, gen)
        else:
            self.backbone.load_state_dict(convert_variables(
                {"params": variables["params"]["backbone"],
                 "batch_stats": variables["batch_stats"]["backbone"]}), strict=True)
            self.head.load_state_dict(convert_variables(
                {"params": variables["params"]["head"]}), strict=True)
        self.backbone.to(self.device)
        self.head.to(self.device)
        self.optimizer = ClipAdam([*self.backbone.parameters(), *self.head.parameters()],
                                  self.config.lr, max_norm=None)

    @property
    def variables(self) -> Dict:
        """JAX's tree, CPU tensors: {"params": {"backbone", "head"},
        "batch_stats": {"backbone"}}."""
        bb = to_flax_variables(self.backbone.state_dict())
        return {"params": {"backbone": bb["params"],
                           "head": to_flax_variables(self.head.state_dict())["params"]},
                "batch_stats": {"backbone": bb.get("batch_stats", {})}}

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device).permute(0, 3, 1, 2)

    def train_step(self, images, labels) -> float:
        """One BCE step on (b, s, s, 3) RGB images and (b,) 0/1 labels: the
        gradients, one Adam update, then the batch statistics applied to
        the running averages."""
        stats = []
        self.optimizer.zero_grad()
        pred = self.head(self.backbone(self._images(images), True, stats))[:, 0]
        labels = torch.as_tensor(labels, dtype=pred.dtype).to(self.device)
        p = torch.clamp(pred, 1e-6, 1 - 1e-6)
        loss = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()
        loss.backward()
        self.optimizer.step()
        update_running_stats(stats)
        return float(loss.detach())

    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """Sigmoid scores with the running statistics."""
        return self.head(self.backbone(self._images(images)))[:, 0]

    def train_epoch(self, dataset, batch_size: int = 8, augment: bool = True,
                    seed: int = 0) -> float:
        """One pass in a seeded order (the permutation, then one flip draw
        an item as it is loaded: JAX's order of draws); a last partial
        batch is dropped."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(dataset))
        losses = []
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs, labels = [], []
            for j in order[i: i + batch_size]:
                img, label = dataset[int(j)]
                if augment:
                    img, label = augment_flip(img, label, rng)
                imgs.append(img)
                labels.append(label)
            losses.append(self.train_step(np.stack(imgs), np.asarray(labels, np.float32)))
        return float(np.mean(losses)) if losses else 0.0

    def evaluate(self, dataset, batch_size: int = 8) -> Dict[str, float]:
        trues, preds = [], []
        for i in range(0, len(dataset), batch_size):
            items = [dataset[j] for j in range(i, min(i + batch_size, len(dataset)))]
            pred = self.predict(np.stack([it[0] for it in items])).cpu().numpy()
            preds.append(pred > 0.5)
            trues.append(np.asarray([it[1] for it in items], bool))
        return binary_prf(np.concatenate(trues), np.concatenate(preds))

    def cross_validate(self, root: str, n_epochs: int = 1, batch_size: int = 8,
                       ckpt_dir: Optional[str] = None,
                       augment: bool = True) -> List[Dict[str, float]]:
        """Leave-one-session-out cross-validation, a fresh model a fold
        (``reset(fold)``), each fold's best-F1 epoch saved as checkpoint
        ``fold`` under ``ckpt_dir``; returns each fold's final metrics."""
        sessions = sorted(os.listdir(root))
        results = []
        for fold, (train_s, test_s) in enumerate(session_splits(sessions)):
            self.reset(seed=fold)
            train_data = WatchingDataset(root, train_s, self.config.crop_size)
            test_data = WatchingDataset(root, test_s, self.config.crop_size)
            best_f1 = -1.0
            for epoch in range(n_epochs):
                loss = self.train_epoch(train_data, batch_size, augment=augment, seed=epoch)
                metrics = self.evaluate(test_data, batch_size)
                self.logger.log({"fold": fold, "loss": loss, **metrics}, step=epoch)
                if ckpt_dir and metrics["f1"] > best_f1:
                    best_f1 = metrics["f1"]
                    ckpt.save_checkpoint(ckpt_dir, fold, self.variables,
                                         meta={"fold": fold, "f1": metrics["f1"]})
            results.append(self.evaluate(test_data, batch_size))
        return results


def evaluate_gaze_heuristic(detector, labeled_frames) -> Dict[str, float]:
    """Run a focus detector's ``estimate`` over (frame, is_focused) pairs
    and score its verdicts; frames it returns None for are skipped."""
    trues, preds = [], []
    for frame, label in labeled_frames:
        res = detector.estimate(frame)
        if res is None:
            continue
        focus, _ = res
        preds.append(bool(focus))
        trues.append(bool(label))
    return binary_prf(np.asarray(trues), np.asarray(preds))

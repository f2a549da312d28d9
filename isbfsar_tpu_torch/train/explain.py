"""Explainability: attention maps + Grad-CAM (port of
``isbfsar_tpu/train/explain.py``).

Rebuild of the reference's heatmap visualizer (reference
modules/ar/visualize_heatmaps.py:17-235): it hooks ResNet layer-4
activations/gradients, backprops the chosen class logit, and renders
per-frame CAMs plus the strongest cross-attention tuple pairs.

- attention comes straight out of the transformer's return dict
  (``models/trx.py``)
- Grad-CAM runs a ResNet-50 built with ``enable_cam=True``, which returns
  its float32 last-stage activation beside the logits; ``torch.autograd``
  takes the class score's gradient against it, where JAX takes ``jax.grad``
  of a zero perturbation added at the same point.

``grad_cam`` and ``explain_episode`` run on the card unless ``device`` says
otherwise, in float32 without TF32. ``render_cam_overlay`` needs cv2 (host
only: the card machine has none, and there it raises ``ImportError``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import float32_device
from isbfsar_tpu_torch.models.resnet import Bottleneck, ResNet
from isbfsar_tpu_torch.ops.tuples import frame_tuples
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_variables


def top_attention_pairs(
    attention: np.ndarray, seq_len: int, class_idx: int, k: int = 5
) -> List[Dict]:
    """Strongest (query-tuple, support-tuple) pairs for one class.

    attention: (way, T, T) from a batch element (model output
    ``attention[b]``). Returns the top-k pairs with their frame indices —
    the reference renders exactly these (visualize_heatmaps.py).
    """
    tuples = frame_tuples(seq_len, 2)
    att = np.asarray(attention)[class_idx]  # (T_q, T_s)
    flat = np.argsort(att, axis=None)[::-1][:k]
    out = []
    for idx in flat:
        qi, si = np.unravel_index(idx, att.shape)
        out.append(
            {
                "score": float(att[qi, si]),
                "query_frames": tuples[qi].tolist(),
                "support_frames": tuples[si].tolist(),
            }
        )
    return out


def cam_resnet50(variables: Mapping, n_classes: int = 0, device="cuda") -> ResNet:
    """The CAM-enabled float32 ResNet-50 with a ``n_classes`` head, from Flax
    variables ``{"params", "batch_stats"}`` (a ``"perturbations"``
    collection, which JAX's CAM init carries, is ignored), on ``device`` in
    inference mode."""
    model = ResNet(stage_sizes=(3, 4, 6, 3), block=Bottleneck, num_classes=n_classes,
                   dtype=torch.float32, enable_cam=True)
    model.load_state_dict(convert_variables(
        {k: v for k, v in variables.items() if k in ("params", "batch_stats")}), strict=True)
    return model.to(float32_device(device)).eval()


def grad_cam(
    variables: Mapping,
    images,
    class_idx: int = 0,
    n_classes: int = 0,
    device="cuda",
) -> np.ndarray:
    """Per-image CAM heatmaps from a CAM-enabled ResNet-50.

    variables: the ResNet-50's Flax variables with a classifier head
    (num_classes=n_classes); images: (n, h, w, 3) float, NHWC as JAX's.
    Returns (n, h/32, w/32) heatmaps, each divided by its max + 1e-8.
    """
    model = cam_resnet50(variables, n_classes, device)
    x = to_device(np.asarray(images, np.float32), next(model.parameters()).device)
    out, acts = model(x.permute(0, 3, 1, 2))
    target = out[:, class_idx] if out.ndim == 2 and out.shape[1] > 1 else out.reshape(-1)
    (g,) = torch.autograd.grad(target.sum(), acts)  # d score / d activation, (n, c, h', w')
    weights = g.mean(dim=(2, 3), keepdim=True)  # GAP of gradients
    cam = torch.relu((weights * acts).sum(dim=1))  # (n, h', w')
    cam = cam / (cam.amax(dim=(1, 2), keepdim=True) + 1e-8)
    return cam.detach().cpu().numpy()


@torch.no_grad()
def explain_episode(
    config: ARConfig,
    params: Mapping,
    support: Dict,
    query: Dict,
    device="cuda",
) -> Dict:
    """Full explanation bundle for one episode: logits, chosen class, and the
    strongest attention pairs for that class (skeleton + rgb modes).
    params: the recognizer's Flax variables (``{"params": ...}``, with
    ``"batch_stats"`` for rgb and hybrid); support/query: numpy clips,
    (b, way, L, ...) and (b, L, ...) per modality."""
    from isbfsar_tpu_torch.train.evals import load_model

    model, dev = load_model(config, params, device)
    b = next(iter(query.values())).shape[0]
    mask = torch.ones((b, config.way), dtype=torch.bool, device=dev)
    out = model({m: to_device(np.asarray(v, np.float32), dev) for m, v in query.items()}, mask,
                support_data={m: to_device(np.asarray(v, np.float32), dev)
                              for m, v in support.items()})
    logits = out["logits"].cpu().numpy()
    chosen = int(np.argmax(logits, 1)[0])
    pairs = top_attention_pairs(out["attention"].cpu().numpy()[0], config.seq_len, chosen)
    return {
        "logits": logits[0],
        "is_true": float(out["is_true"][0, 0]),
        "chosen_class": chosen,
        "top_attention_pairs": pairs,
    }


def render_cam_overlay(image: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """Upscale a CAM onto the image as a red overlay (uint8 BGR)."""
    import cv2

    h, w = image.shape[:2]
    heat = cv2.resize((cam * 255).astype(np.uint8), (w, h))
    heat = cv2.applyColorMap(heat, cv2.COLORMAP_JET)
    return cv2.addWeighted(image.astype(np.uint8), 0.6, heat, 0.4, 0)

"""Offline evaluations beyond FSOS (port of ``isbfsar_tpu/train/evals.py``):

- :func:`episodic_test`: episodic accuracy on held-out classes, with the
  few-shot accuracy and the open-set accuracy, precision, recall and F1;
- :func:`discriminator_confusion`: the mean discriminator score with the
  support set pinned to one class and the queries drawn from another, per
  (support, query) pair of classes.

- :func:`plot_fsos` and :func:`plot_confusion`: their PNGs, drawn by
  matplotlib with the Agg backend, imported when called (host only: the
  card machine has no matplotlib, and there they raise ``ImportError``).

:func:`load_model` and :func:`episode_forward` are shared with
``train/fsos.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import float32_device
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.train.dataloader import (EpisodicSampler, _clip_subdirs, batch_iterator,
                                                list_classes)
from isbfsar_tpu_torch.utils.metrics import binary_prf
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_variables


def load_model(config: ARConfig, params: Mapping, device: str):
    """(TRXOS with ``params`` on ``device`` for inference, the device).
    ``params``: Flax variables ``{"params": ...}``, with ``"batch_stats"``
    for an rgb or hybrid model (its BatchNorm running averages), or the
    bare parameter tree."""
    dev = float32_device(device)
    if "params" not in params:
        params = {"params": params}
    model = TRXOS(config)
    model.load_state_dict(convert_variables(
        {"params": params["params"], "batch_stats": params.get("batch_stats") or {}}),
        strict=True)
    return model.to(dev).eval(), dev


@torch.no_grad()
def episode_forward(model: TRXOS, dev: torch.device, support: Dict, mask: torch.Tensor,
                    target: Dict):
    """Numpy clips -> (argmax class (b,), open-set score (b,)) as numpy."""
    out = model({m: to_device(np.asarray(v, np.float32), dev) for m, v in target.items()},
                mask,
                support_data={m: to_device(np.asarray(v, np.float32), dev)
                              for m, v in support.items()})
    return out["logits"].argmax(dim=1).cpu().numpy(), out["is_true"][:, 0].cpu().numpy()


def episodic_test(
    config: ARConfig,
    params,
    queries_path: str,
    test_classes: Optional[List[str]] = None,
    n_task: int = 100,
    batch_size: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> Dict[str, float]:
    """Episodic accuracy on (held-out) classes; each known episode is paired
    with its unknown episode for the open-set negatives."""
    model, dev = load_model(config, params, device)
    sampler = EpisodicSampler(
        queries_path, k=config.way, n_task=n_task, max_l=16, l=config.seq_len,
        input_type=config.input_type, seed=seed,
    )
    if test_classes:
        sampler.all_classes = [c for c in sampler.all_classes if c in test_classes]

    fs_hits, os_true, os_pred = [], [], []
    for batch in batch_iterator(sampler, batch_size, seed=seed):
        b = batch["target_class"].shape[0]
        mask = torch.ones((b, config.way), dtype=torch.bool, device=dev)
        pred, is_true = episode_forward(model, dev, batch["support_set"], mask,
                                        batch["target_set"])
        target_idx = np.argmax(
            np.asarray(batch["support_classes"]) == np.asarray(batch["target_class"])[:, None],
            axis=1,
        )
        fs_hits.append(pred == target_idx)
        os_pred.append(is_true > 0.5)
        os_true.append(np.ones(b, bool))

        _, is_true_u = episode_forward(model, dev, batch["support_set"], mask,
                                       batch["unknown_set"])
        os_pred.append(is_true_u > 0.5)
        os_true.append(np.zeros(b, bool))

    prf = binary_prf(np.concatenate(os_true), np.concatenate(os_pred))
    return {
        "fs_accuracy": float(np.concatenate(fs_hits).mean()),
        "os_accuracy": prf["accuracy"],
        "os_precision": prf["precision"],
        "os_recall": prf["recall"],
        "os_f1": prf["f1"],
    }


def discriminator_confusion(
    config: ARConfig,
    params,
    queries_path: str,
    exemplars_path: str,
    classes: Optional[List[str]] = None,
    max_queries_per_class: int = 8,
    device: str = "cuda",
) -> np.ndarray:
    """(n_classes, n_classes) mean discriminator score: rows are the support
    class, columns the query class."""
    model, dev = load_model(config, params, device)
    loader = EpisodicSampler(
        queries_path, max_l=16, l=config.seq_len, input_type=config.input_type
    )
    classes = classes or list_classes(exemplars_path)
    n = len(classes)

    # one exemplar clip per class, tiled into the way-wide support tensor
    exemplars = {c: loader.load_clip(_clip_subdirs(os.path.join(exemplars_path, c))[0])
                 for c in classes}
    mask = torch.zeros((1, config.way), dtype=torch.bool, device=dev)
    mask[:, :1] = True

    matrix = np.zeros((n, n), np.float64)
    for i, s_class in enumerate(classes):
        ss = {m: np.tile(v[None, None], (1, config.way) + (1,) * v.ndim)
              for m, v in exemplars[s_class].items()}
        for j, q_class in enumerate(classes):
            base = os.path.join(queries_path, q_class)
            scores = []
            for clip_dir in _clip_subdirs(base)[:max_queries_per_class]:
                q = loader.load_clip(clip_dir)
                _, score = episode_forward(model, dev, ss, mask, {m: v[None] for m, v in q.items()})
                scores.append(float(score[0]))
            matrix[i, j] = float(np.mean(scores)) if scores else np.nan
    return matrix


def plot_fsos(results: Dict[str, List[float]], path: str) -> None:
    """Bar plot of FSOS/FS/OS means +/- std (reference plot_fsos_graph.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in ("FSOS-ACC", "FS-ACC", "OS-ACC") if results.get(k)]
    means = [float(np.mean(results[k])) for k in keys]
    stds = [float(np.std(results[k])) for k in keys]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.bar(keys, means, yerr=stds, capsize=4)
    ax.set_ylim(0, 1)
    ax.set_ylabel("accuracy")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_confusion(matrix: np.ndarray, classes: List[str], path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(matrix, vmin=0, vmax=1, cmap="viridis")
    ax.set_xticks(range(len(classes)), classes, rotation=90, fontsize=6)
    ax.set_yticks(range(len(classes)), classes, fontsize=6)
    ax.set_xlabel("query class")
    ax.set_ylabel("support class")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)

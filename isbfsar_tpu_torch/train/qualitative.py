"""Qualitative episode renderer (port of ``isbfsar_tpu/train/qualitative.py``).

Rebuild of the reference's ``create_qualitative_draw.py`` (reference
modules/ar/utils/test/create_qualitative_draw.py:63-136): draw a random
K-way episode, run the model on the query AND an unknown clip, and render
the skeleton clips with the prediction printed alongside.

Headless redesign: instead of an interactive matplotlib window writing
one PNG per frame per clip (the reference blocks on ``input()`` between
episodes), each episode renders as ONE grid artifact —

    rows   = the K support clips + the query clip + the unknown clip
    cols   = ``n_cols`` frames sampled uniformly across the sequence
    titles = class names; the query row carries predicted-vs-true labels
             with the softmax confidence and the open-set score, the
             unknown row its is_true score (should be low)

so a training run can drop ``episode_*.png`` receipts into its log dir
without a display. The skeletons draw through the same fixed oblique
projection as the live GUI panel (runtime/visualizer.py::GUIVisualizer).

The model's part, :func:`episode_scores`, is plain torch and runs on the
card; the drawing needs matplotlib (host only: the card machine has none,
and there :func:`render_episode` raises ``ImportError``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.runtime.visualizer import GUIVisualizer
from isbfsar_tpu_torch.train.dataloader import EpisodicSampler
from isbfsar_tpu_torch.utils.transfer import to_device

# THE projection the live GUI panel uses (one source of truth — the
# receipts must render the same geometry the operator sees)
_project = GUIVisualizer._project


def _draw_clip_row(fig, gs, row: int, clip: np.ndarray, edges, n_cols: int,
                   title: str, color: str = "tab:purple") -> None:
    from matplotlib.collections import LineCollection

    length = clip.shape[0]
    picks = np.linspace(0, length - 1, n_cols).astype(int)
    for c, t in enumerate(picks):
        ax = fig.add_subplot(gs[row, c])
        ax.set_xticks([])
        ax.set_yticks([])
        pose = clip[t].reshape(-1, 3)
        p2 = _project(pose)
        if edges is not None:
            ax.add_collection(
                LineCollection(p2[np.asarray(edges, int)], colors=color, linewidths=1.5)
            )
        ax.plot(p2[:, 0], p2[:, 1], ".", color=color, markersize=2)
        span = max(float(np.abs(p2).max()), 1e-3) * 1.1
        ax.set_xlim(-span, span)
        ax.set_ylim(-span, span)
        if c == 0:
            ax.set_ylabel(title, fontsize=7, rotation=0, ha="right", va="center")


def render_episode(
    support: np.ndarray,
    support_names: List[str],
    query: np.ndarray,
    query_name: str,
    probs: np.ndarray,
    is_true: float,
    edges,
    path: str,
    unknown: Optional[np.ndarray] = None,
    unknown_name: Optional[str] = None,
    is_true_unknown: Optional[float] = None,
    n_cols: int = 6,
) -> str:
    """Render one episode grid to ``path``. support: (k, L, j*3);
    query/unknown: (L, j*3); probs: (k,) softmax over support classes."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    k = support.shape[0]
    n_rows = k + 1 + (1 if unknown is not None else 0)
    fig = plt.figure(figsize=(1.4 * n_cols, 1.3 * n_rows))
    gs = fig.add_gridspec(n_rows, n_cols, hspace=0.35, wspace=0.1)

    for i in range(k):
        _draw_clip_row(fig, gs, i, support[i], edges, n_cols,
                       f"SUPPORT\n{support_names[i]}")

    pred_idx = int(np.argmax(probs))
    correct = support_names[pred_idx] == query_name
    _draw_clip_row(
        fig, gs, k, query, edges, n_cols,
        f"QUERY\n{query_name}", color="tab:green" if correct else "tab:red",
    )
    fig.suptitle(
        f"pred: {support_names[pred_idx]} (p={float(probs[pred_idx]):.2f}) "
        f"{'==' if correct else '!='} true: {query_name} | "
        f"is_true={is_true:.2f}"
        + (f" | unknown '{unknown_name}' is_true={is_true_unknown:.2f}"
           if unknown is not None else ""),
        fontsize=9,
    )
    if unknown is not None:
        _draw_clip_row(fig, gs, k + 1, unknown, edges, n_cols,
                       f"UNKNOWN\n{unknown_name}", color="tab:orange")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110, facecolor="white")
    plt.close(fig)
    return path


@torch.no_grad()
def episode_scores(model, dev: torch.device, support: np.ndarray, query: np.ndarray,
                   unknown: np.ndarray):
    """One episode's skeleton clips through the recognizer: support (k, L,
    j*3), query and unknown (L, j*3) -> (softmax over the support classes
    (k,), the query's is_true, the unknown's is_true), on the host."""
    mask = torch.ones((1, support.shape[0]), dtype=torch.bool, device=dev)
    sup = {"sk": to_device(np.asarray(support[None], np.float32), dev)}
    out = []
    for clip in (query, unknown):
        res = model({"sk": to_device(np.asarray(clip[None], np.float32), dev)}, mask,
                    support_data=sup)
        out.append((torch.softmax(res["logits"], dim=-1)[0], res["is_true"][0, 0]))
    (probs, ist), (_, ist_un) = out
    return probs.cpu().numpy(), float(ist), float(ist_un)


def qualitative_episodes(
    config: ARConfig,
    params,
    queries_path: str,
    out_dir: str,
    n_episodes: int = 3,
    exemplars_path: Optional[str] = None,
    seed: int = 0,
    n_cols: int = 6,
    device="cuda",
) -> List[Dict]:
    """Draw ``n_episodes`` random episodes, run the model, render one grid
    PNG each (reference create_qualitative_draw.py's loop, headless).
    Returns one {"path", "pred", "true", "probs", "is_true",
    "is_true_unknown"} record per episode."""
    from isbfsar_tpu_torch.train.evals import load_model

    model, dev = load_model(config, params, device)
    sampler = EpisodicSampler(
        queries_path, k=config.way, n_task=n_episodes, max_l=16,
        l=config.seq_len, input_type=config.input_type,
        exemplars_path=exemplars_path, seed=seed,
    )
    records = []
    for i in range(n_episodes):
        ep = sampler[i]
        support = ep["support_set"]["sk"]  # (k, L, j*3)
        query = ep["target_set"]["sk"]
        unknown = ep["unknown_set"]["sk"]
        names = [sampler.all_classes[c] for c in ep["support_classes"]]
        true_name = sampler.all_classes[ep["target_class"]]
        unknown_name = sampler.all_classes[ep["unknown_class"]]

        probs, ist, ist_un = episode_scores(model, dev, support, query, unknown)
        path = render_episode(
            support, names, query, true_name, probs, ist,
            sampler.edges, os.path.join(out_dir, f"episode_{i}.png"),
            unknown=unknown, unknown_name=unknown_name,
            is_true_unknown=ist_un, n_cols=n_cols,
        )
        records.append({
            "path": path,
            "pred": names[int(np.argmax(probs))],
            "true": true_name,
            "probs": probs,
            "is_true": ist,
            "is_true_unknown": ist_un,
        })
    return records

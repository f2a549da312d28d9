"""FSOS evaluation protocol (port of ``isbfsar_tpu/train/fsos.py``):
few-shot and open-set accuracy.

Each repeat draws K support classes from the held-out classes, builds an
exemplar support set, runs every query clip, and scores

- FS-ACC: argmax accuracy on known queries;
- OS-ACC: (is_true > os_threshold) == known over all queries;
- FSOS-ACC: known & FS-correct & OS-correct, or unknown & OS-correct.

The evaluation mask is ``k_eff = min(k, n_test_classes)`` wide, not
``way`` wide. :func:`calibrate_os_threshold` picks the open-set threshold
on training classes; :func:`metrics_at_threshold` re-scores collected
(score, known, fs_correct) triples at another threshold without running
the model again.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.train.dataloader import FSOSEpisodicSampler, batch_iterator, list_classes
from isbfsar_tpu_torch.train.evals import episode_forward, load_model


def evaluate_fsos(
    config: ARConfig,
    params,
    queries_path: str,
    exemplars_path: str,
    k: int = 5,
    n_repeats: int = 10,
    batch_size: int = 8,
    n_test_classes: Optional[int] = None,
    seed: int = 0,
    os_threshold: float = 0.5,
    collect_raw: bool = False,
    exclude_exemplar_queries: bool = False,
    device: str = "cuda",
) -> Dict[str, List[float]]:
    """``params``: the recognizer's Flax variables ``{"params": ...}`` or the
    bare parameter tree (``Trainer.params``), numpy or tensor leaves.
    ``collect_raw`` also returns each repeat's per-query (score, known,
    fs_correct) under ``"_raw"``. ``exclude_exemplar_queries`` drops the
    exemplar clips from the queries (for queries_path == exemplars_path)."""
    model, dev = load_model(config, params, device)
    rng = random.Random(seed)
    # the ids index the exemplar tree, so the count comes from that tree
    if n_test_classes is None:
        n_test_classes = len(list_classes(exemplars_path))

    results: Dict[str, List] = {"FSOS-ACC": [], "FS-ACC": [], "OS-ACC": []}
    raw: List[Dict[str, np.ndarray]] = []
    k_eff = min(k, n_test_classes)
    for _ in range(n_repeats):
        sampler = FSOSEpisodicSampler(
            queries_path,
            exemplars_path,
            support_class_ids=rng.sample(range(n_test_classes), k_eff),
            l=config.seq_len,
            input_type=config.input_type,
            exclude_exemplar_queries=exclude_exemplar_queries,
        )
        fs_hits: List[np.ndarray] = []
        os_hits: List[np.ndarray] = []
        fsos_hits: List[np.ndarray] = []
        rep_scores: List[np.ndarray] = []
        rep_known: List[np.ndarray] = []
        rep_fs: List[np.ndarray] = []

        # drop_last=False: queries are listed class by class, so dropping
        # the tail would under-sample the last class on every repeat
        for batch in batch_iterator(sampler, batch_size, shuffle=False, drop_last=False):
            b = batch["target_class"].shape[0]
            mask = torch.ones((b, k_eff), dtype=torch.bool, device=dev)
            pred, scores = episode_forward(model, dev, batch["support_set"], mask,
                                           batch["target_set"])

            known = np.asarray(batch["known"], bool)
            sc = np.asarray(batch["support_classes"])
            tc = np.asarray(batch["target_class"])[:, None]
            target_idx = np.argmax(sc == tc, axis=1)
            os_pred = scores > os_threshold

            true_os = os_pred == known
            true_fs = pred == target_idx
            os_hits.append(true_os)
            fs_hits.append(true_fs[known])
            fsos_hits.append((known & true_fs & true_os) | (~known & true_os))
            if collect_raw:
                rep_scores.append(scores)
                rep_known.append(known)
                rep_fs.append(true_fs)

        def ratio(parts):
            flat = np.concatenate(parts) if parts else np.zeros(0)
            return float(flat.mean()) if flat.size else -1.0

        results["FS-ACC"].append(ratio(fs_hits))
        results["OS-ACC"].append(ratio(os_hits))
        results["FSOS-ACC"].append(ratio(fsos_hits))
        if collect_raw:
            raw.append({
                "scores": np.concatenate(rep_scores) if rep_scores else np.zeros(0),
                "known": np.concatenate(rep_known) if rep_known else np.zeros(0, bool),
                "fs_correct": np.concatenate(rep_fs) if rep_fs else np.zeros(0, bool),
            })
    if collect_raw:
        results["_raw"] = raw
    return results


def metrics_at_threshold(
    raw: List[Dict[str, np.ndarray]], os_threshold: float
) -> Dict[str, List[float]]:
    """Re-score collected (score, known, fs_correct) triples at another
    open-set threshold."""
    out: Dict[str, List[float]] = {"FSOS-ACC": [], "FS-ACC": [], "OS-ACC": []}
    for rep in raw:
        scores, known, fs = rep["scores"], rep["known"], rep["fs_correct"]
        true_os = (scores > os_threshold) == known
        out["OS-ACC"].append(float(true_os.mean()) if scores.size else -1.0)
        out["FS-ACC"].append(float(fs[known].mean()) if known.any() else -1.0)
        out["FSOS-ACC"].append(
            float(((known & fs & true_os) | (~known & true_os)).mean())
            if scores.size else -1.0
        )
    return out


def calibrate_os_threshold(
    config: ARConfig,
    params,
    tree_path: str,
    k: int = 5,
    n_repeats: int = 10,
    batch_size: int = 8,
    seed: int = 0,
    grid: Optional[np.ndarray] = None,
    device: str = "cuda",
) -> Dict[str, float]:
    """The open-set threshold picked on training classes: the FSOS protocol
    with ``tree_path`` as both query and exemplar tree (the exemplar clips
    left out of the queries), and the threshold of the grid that maximizes
    balanced accuracy (the mean of the known TPR and the unknown TNR).

    Returns {os_threshold, balanced_acc, os_acc_at_default, os_acc_at_best,
    n_queries}; report it beside the 0.5-protocol numbers, not instead."""
    res = evaluate_fsos(
        config, params, tree_path, tree_path, k=k, n_repeats=n_repeats,
        batch_size=batch_size, seed=seed, collect_raw=True,
        exclude_exemplar_queries=True, device=device,
    )
    raw = res["_raw"]
    scores = np.concatenate([r["scores"] for r in raw])
    known = np.concatenate([r["known"] for r in raw])
    if grid is None:
        grid = np.linspace(0.02, 0.98, 97)
    best_thr, best_bal = 0.5, -1.0
    for t in grid:
        pred = scores > t
        tpr = float(pred[known].mean()) if known.any() else 0.0
        tnr = float((~pred[~known]).mean()) if (~known).any() else 0.0
        bal = 0.5 * (tpr + tnr)
        if bal > best_bal:
            best_bal, best_thr = bal, float(t)
    return {
        "os_threshold": round(best_thr, 3),
        "balanced_acc": round(best_bal, 3),
        "os_acc_at_default": round(float(((scores > 0.5) == known).mean()), 3),
        "os_acc_at_best": round(float(((scores > best_thr) == known).mean()), 3),
        "n_queries": int(scores.size),
    }


def summarize(results: Dict[str, List[float]]) -> Dict[str, str]:
    return {
        k: f"{np.mean(v):.3f} +/- {np.std(v):.3f}"
        for k, v in results.items() if v and not k.startswith("_")
    }

"""Episodic data pipeline (port of ``isbfsar_tpu/train/dataloader.py``).

- :class:`EpisodicSampler`: each item is a random k-way episode
  {support_set, target_set, unknown_set, support_classes, target_class,
  unknown_class, known}; a clip of ``max_l`` frames is subsampled to ``l``
  by a stride; a corrupt clip retries another random clip, or falls back to
  the first sample loaded when the clip was pinned.
- :class:`FSOSEpisodicSampler`: a fixed exemplar support set and every
  query of the test classes, for the FSOS protocol.
- :func:`batch_iterator`: episodes collated into numpy batches by a thread
  pool.

The tree is ``root/<class>/<clip>/{i}.npy``, one (122, 3) float32
root-relative pose per frame, and ``{i}.png`` for rgb and hybrid, the
person's crop, as the reference's extraction writes it. A PNG is decoded
by ``utils/png.py`` (cv2's ``imread`` in numpy), resized to 224x224 by
``ops/image.py::resize_linear_u8`` (cv2's ``INTER_LINEAR``) and whitened in
float64 with the ImageNet constants in BGR order, the reference's quirk;
every ``max_l`` frame of a clip is decoded, though only every
``max_l // l``-th is kept.

Episode order: ``batch_iterator`` builds each batch with ``pool.map`` over
``num_threads`` threads, and every ``__getitem__`` draws from the sampler's
one ``random.Random``. Which episode gets which draw therefore depends on
thread scheduling, in this package as in the JAX package it copies; with
``num_threads=1`` the episodes are a function of the seeds alone.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from isbfsar_tpu_torch.ops.image import IMAGENET_SCALE, IMAGENET_SHIFT, resize_linear_u8
from isbfsar_tpu_torch.utils.png import read_png
from isbfsar_tpu_torch.utils.skeleton import get_skeleton

RGB_SIZE = 224
# (u / 255.0) * scale + shift in float64 for every byte value u, per channel
# (BGR order, the ImageNet constants as they are): the whitening looked up
_WHITEN = (np.arange(256)[:, None] / 255.0 * np.array(IMAGENET_SCALE)
           + np.array(IMAGENET_SHIFT)).T.copy()


def list_classes(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def _clip_subdirs(base: str) -> List[str]:
    """Clip directories under a class directory; directories only (the
    extraction leaves ``.skip_<idx>`` marker files beside them)."""
    return sorted(
        os.path.join(base, d)
        for d in os.listdir(base)
        if os.path.isdir(os.path.join(base, d))
    )


def _load_frame_pose(path: str, i: int) -> np.ndarray:
    return np.load(os.path.join(path, f"{i}.npy"))


def _load_frame_image(path: str, i: int) -> np.ndarray:
    """Frame ``i``'s crop, whitened, float64 (224, 224, 3); a missing frame
    raises ``FileNotFoundError``."""
    img = read_png(os.path.join(path, f"{i}.png"))
    if img.shape[:2] != (RGB_SIZE, RGB_SIZE):  # cv2's resize to the same size copies
        img = resize_linear_u8(img, RGB_SIZE, RGB_SIZE)
    out = np.empty(img.shape, np.float64)
    for c in range(3):
        out[..., c] = _WHITEN[c][img[..., c]]
    return out


class EpisodicSampler:
    """Random k-way episodes."""

    def __init__(
        self,
        queries_path: str,
        k: int = 5,
        n_task: int = 10000,
        max_l: int = 16,
        l: int = 8,
        input_type: str = "skeleton",
        exemplars_path: Optional[str] = None,
        support_classes: Optional[List[str]] = None,
        query_class: Optional[str] = None,
        skeleton: str = "smpl+head_30",
        seed: Optional[int] = None,
    ):
        self.queries_path = queries_path
        self.k = k
        self.max_l = max_l
        self.l = l
        self.input_type = input_type
        self.exemplars_path = exemplars_path
        self.support_classes = support_classes
        self.all_classes = list_classes(queries_path)
        self.rng = random.Random(seed)

        self.n_task = n_task
        self.query_class = query_class
        self.queries: Optional[List[str]] = None
        if query_class:
            base = os.path.join(queries_path, query_class)
            self.queries = _clip_subdirs(base)
            self.n_task = len(self.queries)
        self.default_sample = None
        self._clip_dir_cache: Dict = {}

        spec = get_skeleton(skeleton)
        self.indices = list(spec.indices)
        self.edges = spec.edges

    def _clip_dirs(self, class_name: str, use_exemplars: bool) -> List[str]:
        key = (class_name, use_exemplars)
        hit = self._clip_dir_cache.get(key)
        if hit is None:
            root = self.exemplars_path if use_exemplars else self.queries_path
            hit = _clip_subdirs(os.path.join(root, class_name))
            self._clip_dir_cache[key] = hit
        return hit

    def load_clip(self, path: str) -> Dict[str, np.ndarray]:
        poses, imgs = [], []
        for i in range(self.max_l):
            if self.input_type in ("skeleton", "hybrid"):
                pose = _load_frame_pose(path, i)
                poses.append(pose[self.indices].reshape(-1))
            if self.input_type in ("rgb", "hybrid"):
                imgs.append(_load_frame_image(path, i))
        sample = {}
        sub = list(range(0, self.max_l, self.max_l // self.l)) if self.l != self.max_l else None
        if poses:
            stack = np.stack(poses).astype(np.float32)
            sample["sk"] = stack if sub is None else stack[sub]
        if imgs:
            stack = np.stack(imgs).astype(np.float32)
            sample["rgb"] = stack if sub is None else stack[sub]
        return sample

    def get_sample(self, class_name: str, ss: bool = False, path: Optional[str] = None):
        """A clip, retrying a corrupt random clip up to 8 times; a corrupt
        pinned clip gives the first sample loaded."""
        pinned = path is not None
        for _ in range(8):
            try:
                if path is None:
                    use_ex = ss and self.exemplars_path is not None
                    path = self.rng.choice(self._clip_dirs(class_name, use_ex))
                sample = self.load_clip(path)
                if self.default_sample is None:
                    self.default_sample = sample
                return sample
            except (OSError, EOFError, ValueError, IndexError):  # an unreadable clip
                if pinned and self.default_sample is not None:
                    return self.default_sample
                path = None
        if self.default_sample is None:
            raise RuntimeError(
                f"could not load any clip for class {class_name!r} after 8 "
                f"attempts and no earlier sample is cached — check the "
                f"dataset tree under {self.queries_path!r}"
            )
        return self.default_sample

    def __getitem__(self, idx: int) -> Dict:
        support_classes = (
            self.support_classes
            if self.support_classes
            else self.rng.sample(self.all_classes, self.k)
        )
        if self.queries:
            # pinned-query mode: the target clip is a query_class clip
            target_class = self.query_class
        else:
            target_class = self.rng.choice(support_classes)
        unknown_class = self.rng.choice(
            [c for c in self.all_classes if c not in support_classes]
        )
        support = [self.get_sample(c, ss=True) for c in support_classes]
        target = self.get_sample(
            target_class, path=self.queries[idx] if self.queries else None
        )
        unknown = self.get_sample(unknown_class)
        return {
            "support_set": {
                t: np.stack([s[t] for s in support]) for t in support[0]
            },
            "target_set": target,
            "unknown_set": unknown,
            "support_classes": np.asarray(
                [self.all_classes.index(c) for c in support_classes], np.int32
            ),
            "target_class": self.all_classes.index(target_class),
            "unknown_class": self.all_classes.index(unknown_class),
            "known": target_class in support_classes,
        }

    def __len__(self) -> int:
        return self.n_task


class FSOSEpisodicSampler:
    """Fixed exemplar support set + every query of the test classes."""

    def __init__(
        self,
        queries_path: str,
        exemplars_path: str,
        support_class_ids: List[int],
        l: int = 16,
        max_l: int = 16,
        input_type: str = "skeleton",
        query_class: Optional[str] = None,
        skeleton: str = "smpl+head_30",
        exclude_exemplar_queries: bool = False,
    ):
        self.loader = EpisodicSampler(
            queries_path, max_l=max_l, l=l, input_type=input_type, skeleton=skeleton
        )
        self.all_test_classes = list_classes(exemplars_path)
        self.support_classes = [self.all_test_classes[i] for i in support_class_ids]
        exemplar_paths = [
            _clip_subdirs(os.path.join(exemplars_path, c))[0]
            for c in self.support_classes
        ]
        self.queries: List[str] = []
        for q in self.all_test_classes:
            if query_class and q != query_class:
                continue
            base = os.path.join(queries_path, q)
            if not os.path.isdir(base):
                continue
            self.queries.extend(_clip_subdirs(base))
        if exclude_exemplar_queries:
            # self-calibration (queries_path == exemplars_path): an exemplar
            # clip never scores itself as a query
            drop = set(exemplar_paths)
            self.queries = [q for q in self.queries if q not in drop]
        self.support_set = [self.loader.load_clip(p) for p in exemplar_paths]

    def __getitem__(self, i: int) -> Dict:
        target = self.loader.get_sample(None, path=self.queries[i])
        query_class = os.path.basename(os.path.dirname(self.queries[i]))
        return {
            "support_set": {
                t: np.stack([s[t] for s in self.support_set]) for t in self.support_set[0]
            },
            "target_set": target,
            "support_classes": np.asarray(
                [self.all_test_classes.index(c) for c in self.support_classes], np.int32
            ),
            "target_class": self.all_test_classes.index(query_class),
            "known": query_class in self.support_classes,
        }

    def __len__(self) -> int:
        return len(self.queries)


def _collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], dict):
            out[key] = {t: np.stack([v[t] for v in vals]) for t in vals[0]}
        else:
            out[key] = np.asarray(vals)
    return out


def batch_iterator(
    sampler,
    batch_size: int,
    shuffle: bool = True,
    num_threads: int = 8,
    drop_last: bool = True,
    seed: int = 0,
) -> Iterator[Dict]:
    """Episodes collated into batched numpy trees, built on a thread pool
    (see the module docstring on the order of the draws)."""
    order = list(range(len(sampler)))
    if shuffle:
        random.Random(seed).shuffle(order)
    with cf.ThreadPoolExecutor(max_workers=num_threads) as pool:
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idxs = order[i : i + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            yield _collate(list(pool.map(sampler.__getitem__, idxs)))

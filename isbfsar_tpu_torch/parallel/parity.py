"""Certificates that an n-rank step is the 1-device step (port of
``isbfsar_tpu/parallel/parity.py``).

Each check runs one TRX-OS episodic training step (the loss with the
gated discriminator, the SGD update, BatchNorm's running averages) on one
device and on ``n`` ranks (``launch.run_ranks``, one process each), from
one seeded init and one batch, and asserts the JAX package's bounds and
non-vacuity checks on the difference:

* :func:`dp_parity_check`: DDP; skeleton to ``atol`` 2e-6, rgb (synced
  BatchNorm) to the scale-aware bounds ``param_rel_diff`` <= 0.10 (the
  difference relative to the update itself), stats <= 1e-3 and metrics <=
  0.05, with BatchNorm leaves present and moved off their init;
* :func:`fsdp_parity_check`: FSDP2, 2e-6, more than half of the elements
  split by the rule;
* :func:`tp_parity_check`: a dp x tp mesh (tp 2), 5e-5, at least 4 split
  leaves and more than half of the elements;
* :func:`sp_parity_check`: a dp x sp mesh (sp 2), the BatchNorm bounds,
  and every train-mode extractor apply on L/sp frames (forward hooks on
  the rgb extractor record each apply's frame count);
* :func:`way_sharding_parity_check`: the way-sharded matcher against the
  recognizer's own inference, 1e-5;
* :func:`bn_fault_injection_check`: the negative control, the dp rgb step
  with the BatchNorm sync off, which must land above the rgb bounds by
  more than JAX's margins.

``device`` is where the ranks and the 1-device step run (``"cpu"``: gloo
process groups); ``backend`` overrides the launcher's choice (gloo with
CUDA tensors puts two ranks on one card). ``trees=True`` adds the Flax
trees of the init and of both steps to the report, for a caller that holds
them against another implementation.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.parallel.launch import run_ranks
from isbfsar_tpu_torch.train.synthetic import episodic_batch

TIMEOUT = 300.0
RGB_BOUNDS = {"param_rel_diff": 0.10, "max_stats_diff": 1e-3, "max_metric_diff": 0.05}
# The dp skeleton certificate's loss bound for two ranks on one card: cuBLAS
# picks its kernels by batch size, so the losses of a batch of 2 move when it
# is cut in two even on one device. On an NVIDIA H100 80GB HBM3 the 2-rank
# losses read 2.15e-6 (fs_loss) and the one-device split alone 2.03e-6
# (split_reading); the bound is about four times those. The parameters keep
# JAX's 2e-6 (they read 1.19e-7 there).
CARD_PAIR_METRIC_ATOL = 8e-6


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()  # not a view of a live CPU parameter


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree, np.float64)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"tree structure differs at {path or '/'}")
        for k in sorted(a):
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield np.asarray(a, np.float64), np.asarray(b, np.float64)


def max_diff(a, b) -> float:
    """The worst absolute leaf difference (structures must match)."""
    return max((float(np.max(np.abs(x - y))) if x.size else 0.0 for x, y in _pairs(a, b)),
               default=0.0)


def _l2(pairs) -> float:
    return float(np.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in pairs)))


def param_rel_diff(p1, pn, p_init) -> float:
    """|p1 - pn| relative to the update |p1 - p_init| (L2 over all leaves)."""
    return _l2(_pairs(p1, pn)) / max(_l2(_pairs(p1, p_init)), 1e-12)


def _cfg(modality: str, batch: int, rgb_size: int = 32, **kw) -> ARConfig:
    return dataclasses.replace(ARConfig.for_input(modality), batch_size=batch, n_task=batch,
                               eval_every_n_epoch=10_000, rgb_size=rgb_size, **kw)


def _metric_diff(m1: Dict, mn: Dict) -> float:
    return max(abs(float(m1[k]) - float(mn[k])) for k in m1 if k in mn)


def _step(trainer, batch) -> Dict:
    """One run_epoch step; the init and the result as Flax numpy trees."""
    init = _numpy(trainer.params), _numpy(trainer.batch_stats)
    summary = trainer.run_epoch(0, [batch], train=True)
    return {"init": init, "params": _numpy(trainer.params), "stats": _numpy(trainer.batch_stats),
            "summary": summary}


def one_device_step(cfg: ARConfig, batch: Dict, device: str = "cpu", seed: int = 0) -> Dict:
    """The 1-device trainer's step (this process)."""
    from isbfsar_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as root:
        return _step(Trainer(cfg, log_dir=root, use_wandb=False, seed=seed, device=device), batch)


def _rank_step(cfg: ARConfig, batch: Dict, device: str, mesh_shape: Optional[Tuple[int, int]],
               axes: Tuple[str, ...], param_sharding: str, seq_axis: Optional[str],
               sync_batchnorm: bool = True, seed: int = 0) -> Dict:
    """One rank of an n-rank step (runs in a rank process)."""
    import torch.distributed as dist

    from isbfsar_tpu_torch.parallel.mesh import fsdp_receipt, make_mesh, make_mesh_2d, tp_receipt
    from isbfsar_tpu_torch.train.trainer import Trainer

    mesh = (make_mesh(axis=axes[0], device=device) if mesh_shape is None
            else make_mesh_2d(mesh_shape, axes, device))
    applies = []
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(cfg, log_dir=root, use_wandb=False, seed=seed, device=device,
                          mesh=mesh, param_sharding=param_sharding, seq_axis=seq_axis,
                          sync_batchnorm=sync_batchnorm)
        named = list(zip(trainer.names, trainer.leaves))
        placement = (fsdp_receipt(named, mesh.size(axes.index("dp"))) if param_sharding == "fsdp"
                     else tp_receipt(named))
        if hasattr(trainer.model, "rgb_extractor"):
            trainer.model.rgb_extractor.register_forward_hook(
                lambda mod, args, out: applies.append((int(args[0].shape[0]), bool(args[1]))))
        out = _step(trainer, batch)
    out.update(placement=placement, applies=applies, rank=dist.get_rank())
    return out if dist.get_rank() == 0 else {"applies": applies, "placement": placement}


def _rank_fit(cfg: ARConfig, batches, device: str, param_sharding: str, log_dir: str,
              epochs: int) -> Optional[Dict]:
    """One rank of :func:`fit_over_ranks`."""
    import torch.distributed as dist

    from isbfsar_tpu_torch.parallel.mesh import make_mesh
    from isbfsar_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, log_dir=log_dir, use_wandb=False, device=device,
                      mesh=make_mesh(device=device), param_sharding=param_sharding)
    summary = trainer.fit(epochs, lambda sampler, epoch: batches)
    state = _numpy(trainer.state())  # a collective under fsdp: every rank
    return {"summary": summary, "state": state} if dist.get_rank() == 0 else None


def fit_over_ranks(cfg: ARConfig, batches, n_ranks: int, log_dir: str, epochs: int = 1,
                   param_sharding: str = "replicated", device: str = "cpu",
                   backend: Optional[str] = None) -> Dict:
    """``Trainer.fit`` over ``n_ranks`` (dp) on ``batches`` every epoch; rank
    0's summary and ``state()`` (rank 0 writes the checkpoints)."""
    return run_ranks(_rank_fit, n_ranks, device, TIMEOUT, cfg, batches, device, param_sharding,
                     log_dir, epochs, backend=backend)[0]


def _n_rank_step(n: int, cfg, batch, device, backend, mesh_shape=None, axes=("dp",),
                 param_sharding="replicated", seq_axis=None, sync_batchnorm=True):
    return run_ranks(_rank_step, n, device, TIMEOUT, cfg, batch, device, mesh_shape, axes,
                     param_sharding, seq_axis, sync_batchnorm, backend=backend)


def _report(one: Dict, many: Dict) -> Dict:
    return {"max_param_diff": max_diff(one["params"], many["params"]),
            "param_rel_diff": param_rel_diff(one["params"], many["params"], one["init"][0]),
            "max_stats_diff": max_diff(one["stats"], many["stats"]),
            "max_metric_diff": _metric_diff(one["summary"], many["summary"])}


def _with_trees(report: Dict, one: Dict, many: Dict, trees: bool) -> Dict:
    if trees:
        report["trees"] = {"init": one["init"], "one": one, "many": many}
    return report


def _check(report: Dict, bounds: Dict, what: str, one: Dict, many: Dict) -> None:
    for name, bound in bounds.items():
        assert report[name] <= bound, (
            f"{what} parity violated: {name}={report[name]:.3e} > {bound:.1e}\n"
            f"1-device metrics: {one['summary']}\nn-rank metrics: {many['summary']}")


def dp_parity_check(n_ranks: int, atol: float = 2e-6, modality: str = "skeleton",
                    rgb_size: int = 32, device: str = "cpu", backend: Optional[str] = None,
                    compute_dtype: str = "float32", trees: bool = False,
                    batch_seed: int = 0, one: Optional[Dict] = None) -> Dict:
    """DDP over ``n_ranks`` (one episode each) against the 1-device step
    (``one``: that step's result, if the caller has it). Skeleton: every
    difference within ``atol``. rgb/hybrid: BatchNorm leaves present and
    moved off their init, then ``RGB_BOUNDS``."""
    cfg, batch = _dp_case(n_ranks, modality, rgb_size, compute_dtype, batch_seed)
    many = _n_rank_step(n_ranks, cfg, batch, device, backend)[0]
    one = one or one_device_step(cfg, batch, device)
    return _judge_dp(one, many, modality, n_ranks, atol, trees)


def _dp_case(n_ranks: int, modality: str, rgb_size: int = 32, compute_dtype: str = "float32",
             batch_seed: int = 0):
    cfg = _cfg(modality, n_ranks, rgb_size, compute_dtype=compute_dtype)
    return cfg, episodic_batch(cfg, n_ranks, rgb_size, modality, seed=batch_seed)


def _judge_dp(one: Dict, many: Dict, modality: str, n_ranks: int, atol: float = 2e-6,
              trees: bool = False, metric_atol: Optional[float] = None) -> Dict:
    has_bn = modality in ("rgb", "hybrid")
    if has_bn:
        assert list(_leaves(one["stats"])), f"{modality} dp parity ran without BatchNorm stats"
        assert max_diff(one["stats"], one["init"][1]) > 0.0, "BN stats never updated"
    report = _report(one, many)
    bounds = RGB_BOUNDS if has_bn else {
        "max_param_diff": atol, "max_stats_diff": atol,
        "max_metric_diff": atol if metric_atol is None else metric_atol}
    _check(report, bounds, f"dp ({modality})", one, many)
    report.update(modality=modality, n_ranks=n_ranks,
                  bn_stat_leaves=len(list(_leaves(one["stats"]))))
    return _with_trees(report, one, many, trees)


def _split_frac(placement: Dict, one: Dict) -> float:
    total = sum(x.size for x in _leaves(one["params"]))
    return placement["sharded_elems"] / max(total, 1)


def fsdp_parity_check(n_ranks: int, atol: float = 2e-6, device: str = "cpu",
                      backend: Optional[str] = None, trees: bool = False) -> Dict:
    """FSDP2 over ``n_ranks`` against the 1-device replicated step (skeleton),
    with more than half of the parameter elements split by the rule."""
    cfg = _cfg("skeleton", n_ranks)
    batch = episodic_batch(cfg, n_ranks, 32, "skeleton", seed=0)
    one = one_device_step(cfg, batch, device)
    many = _n_rank_step(n_ranks, cfg, batch, device, backend, param_sharding="fsdp")[0]
    frac = _split_frac(many["placement"], one)
    assert many["placement"]["sharded_leaves"] >= 1 and frac > 0.5, (
        f"fsdp parity ran without real parameter sharding ({many['placement']}, "
        f"{frac:.0%} of elements)")
    report = _report(one, many)
    _check(report, dict.fromkeys(("max_param_diff", "max_stats_diff", "max_metric_diff"), atol),
           "fsdp", one, many)
    report.update(sharded_leaves=many["placement"]["sharded_leaves"],
                  sharded_elem_frac=round(frac, 3))
    return _with_trees(report, one, many, trees)


def tp_parity_check(n_ranks: int, atol: float = 5e-5, device: str = "cpu",
                    backend: Optional[str] = None, trees: bool = False) -> Dict:
    """Tensor parallelism on a dp x tp mesh (tp 2 from 2 ranks up) against
    the 1-device replicated step, with at least 4 split leaves and more
    than half of the elements."""
    tp = 2 if n_ranks >= 2 else 1
    dp = max(1, n_ranks // tp)
    cfg = _cfg("skeleton", dp)
    batch = episodic_batch(cfg, dp, 32, "skeleton", seed=0)
    one = one_device_step(cfg, batch, device)
    many = _n_rank_step(n_ranks, cfg, batch, device, backend, mesh_shape=(dp, tp),
                        axes=("dp", "tp"), param_sharding="tp")[0]
    frac = _split_frac(many["placement"], one)
    assert many["placement"]["sharded_leaves"] >= 4 and frac > 0.5, (
        f"tp parity ran without real tensor sharding ({many['placement']}, {frac:.0%} of "
        "elements)")
    report = _report(one, many)
    _check(report, dict.fromkeys(("max_param_diff", "max_stats_diff", "max_metric_diff"), atol),
           f"tp (dp{dp}xtp{tp})", one, many)
    report.update(mesh=f"dp{dp}xtp{tp}", sharded_leaves=many["placement"]["sharded_leaves"],
                  sharded_elem_frac=round(frac, 3))
    return _with_trees(report, one, many, trees)


def sp_parity_check(n_ranks: int, param_sharding: str = "replicated", modality: str = "rgb",
                    remat: bool = False, device: str = "cpu", backend: Optional[str] = None,
                    batch_size: Optional[int] = None, compute_dtype: str = "float32",
                    trees: bool = False, batch_seed: int = 0,
                    one: Optional[Dict] = None) -> Dict:
    """Sequence parallelism on a dp x sp mesh (sp 2) against the default
    1-device step, to the BatchNorm bounds; every train-mode extractor apply
    of every rank must have run on this rank's L/sp frames. ``remat`` on
    the n-rank side only. ``batch_size`` defaults to dp (one episode per
    dp rank, as JAX's); ``one`` as :func:`dp_parity_check` takes it."""
    if n_ranks < 2:
        return {"skipped": "sequence parallelism needs >= 2 ranks"}
    sp = 2
    dp = n_ranks // sp
    b = batch_size or dp
    cfg = _cfg(modality, b, compute_dtype=compute_dtype)
    batch = episodic_batch(cfg, b, 32, modality, seed=batch_seed)
    one = one or one_device_step(cfg, batch, device)
    ranks = _n_rank_step(n_ranks, dataclasses.replace(cfg, remat=remat), batch, device, backend,
                         mesh_shape=(dp, sp), axes=("dp", "sp"), param_sharding=param_sharding,
                         seq_axis="sp")
    many = ranks[0]
    frames = cfg.seq_len // sp * (b // dp)
    want = {frames, frames * cfg.way}
    applies = [a for r in ranks for a in r["applies"] if a[1]]
    sharded = sum(a[0] in want for a in applies)
    assert len(applies) >= 3 * n_ranks and sharded == len(applies), (
        f"sp parity ran without real sequence sharding: of {len(applies)} train-mode "
        f"extractor applies {sharded} ran on L/sp frames ({applies}, want {sorted(want)})")
    report = _report(one, many)
    _check(report, RGB_BOUNDS, f"sp (dp{dp}xsp{sp})", one, many)
    report.update(mesh=f"dp{dp}xsp{sp}", param_sharding=param_sharding, modality=modality,
                  remat=remat, extractor_applies_sp_sharded=f"{sharded}/{len(applies)}")
    return _with_trees(report, one, many, trees)


def bn_fault_injection_check(n_ranks: int, device: str = "cpu",
                             backend: Optional[str] = None, one: Optional[Dict] = None,
                             compute_dtype: str = "float32", batch_seed: int = 0,
                             trees: bool = False) -> Dict:
    """The negative control: the DDP rgb step with each rank's BatchNorm on
    its own episodes (the sync off) against the 1-device step (``one``, as
    :func:`dp_parity_check` takes it) must exceed the rgb bounds;
    ``rel_diff_margin`` and ``stats_diff_margin`` say by how much."""
    cfg, batch = _dp_case(n_ranks, "rgb", compute_dtype=compute_dtype, batch_seed=batch_seed)
    one = one or one_device_step(cfg, batch, device)
    many = _n_rank_step(n_ranks, cfg, batch, device, backend, sync_batchnorm=False)[0]
    report = _report(one, many)
    report.update(modality="rgb", n_ranks=n_ranks)
    report["rel_diff_margin"] = report["param_rel_diff"] / RGB_BOUNDS["param_rel_diff"]
    report["stats_diff_margin"] = report["max_stats_diff"] / RGB_BOUNDS["max_stats_diff"]
    for name in ("param_rel_diff", "max_stats_diff"):
        assert report[name] > RGB_BOUNDS[name], (
            f"BatchNorm fault undetected: {name}={report[name]:.3e} <= {RGB_BOUNDS[name]:.1e}; "
            "the rgb bounds would pass unsynced statistics")
    return _with_trees(report, one, many, trees)


def _rank_way(way: int, device: str, seed: int = 0) -> Dict:
    """One rank of the way-sharding check: the recognizer's own inference
    beside the matcher's match of the same window."""
    import torch.distributed as dist

    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.parallel.mesh import make_mesh
    from isbfsar_tpu_torch.parallel.support import WayShardedMatcher

    cfg = dataclasses.replace(ARConfig.for_input("skeleton"), way=way)
    ar = ActionRecognizer(cfg, seed=seed, device=device)
    rng = np.random.default_rng(0)
    for i in range(max(1, cfg.way - 3)):  # some masked slots stay empty
        ar.train({"flag": f"class_{i}",
                  "data": {"poses": rng.normal(size=(cfg.seq_len, 90)).astype(np.float32)},
                  "requires_focus": False})
    frames = [rng.normal(size=90).astype(np.float32) for _ in range(cfg.seq_len)]
    for f in frames[:-1]:
        ar.inference({"sk": f})
    ref_probs, ref_ist, _ = ar.inference({"sk": frames[-1]})
    matcher = WayShardedMatcher(ar, make_mesh(device=device))
    probs, ist = matcher.match_window({"sk": np.stack(frames)})
    return {"rank": dist.get_rank(), "ref": (ref_probs, ref_ist), "got": (probs, ist),
            "classes_per_rank": int(matcher._features.shape[0])}


def _rank_matcher(script, way: int, params, device: str) -> Dict:
    """One rank of :func:`matcher_over_ranks`."""
    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.parallel.mesh import make_mesh
    from isbfsar_tpu_torch.parallel.support import WayShardedMatcher

    ar = ActionRecognizer(dataclasses.replace(ARConfig.for_input("skeleton"), way=way),
                          params=params, device=device)
    matcher = WayShardedMatcher(ar, make_mesh(device=device))
    matches = []
    for op, *arg in script:
        if op == "train":
            ar.train({"flag": arg[0], "data": {"poses": arg[1]}, "requires_focus": False})
        elif op == "remove":
            assert ar.remove(arg[0])
        else:
            matches.append(matcher.match_window({"sk": arg[0]}))
    return {"matches": matches, "classes_per_rank": matcher.per_rank}


def matcher_over_ranks(script, way: int, n_ranks: int, params=None, device: str = "cpu",
                       backend: Optional[str] = None):
    """Every rank's ``WayShardedMatcher`` results over a skeleton recognizer
    (``params``: Flax variables with numpy leaves, or None for the seeded
    init) and a script of ("train", name, (L, 90) clip), ("remove", name)
    and ("match", (L, 90) window) steps, which each rank replays."""
    return run_ranks(_rank_matcher, n_ranks, device, TIMEOUT, script, way, params, device,
                     backend=backend)


def way_sharding_parity_check(n_ranks: int, atol: float = 1e-5, device: str = "cpu",
                              backend: Optional[str] = None, way: Optional[int] = None) -> Dict:
    """A ``way`` (default 2 * n_ranks) class support set split over the
    ranks reproduces the recognizer's own probabilities and open-set score
    on every rank."""
    ranks = run_ranks(_rank_way, n_ranks, device, TIMEOUT, way or 2 * n_ranks, device,
                      backend=backend)
    return _judge_way(ranks, atol)


def _judge_way(ranks, atol: float = 1e-5) -> Dict:
    prob_diff = ist_diff = 0.0
    for r in ranks:
        (ref_probs, ref_ist), (probs, ist) = r["ref"], r["got"]
        assert set(probs) == set(ref_probs), (sorted(probs), sorted(ref_probs))
        prob_diff = max([prob_diff] + [abs(probs[k] - ref_probs[k]) for k in ref_probs])
        ist_diff = max(ist_diff, abs(ist - ref_ist))
    report = {"max_prob_diff": prob_diff, "is_true_diff": ist_diff,
              "classes_per_device": ranks[0]["classes_per_rank"], "n_ranks": len(ranks)}
    assert prob_diff <= atol and ist_diff <= atol, f"way-sharding parity violated: {report}"
    return report


def _rank_sequence(jobs) -> list:
    """Several rank functions in turn, in one process group."""
    return [fn(*args) for fn, args in jobs]


def split_reading(cfg: ARConfig, batch: Dict, n: int, device: str = "cpu") -> float:
    """How far the losses of one device move when the batch is cut into
    ``n`` parts (each part's loss, averaged) against the whole batch in one
    call: the batch-size dependence of the device's own kernels, which an
    n-rank step inherits without any collective."""
    from isbfsar_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(cfg, log_dir=root, use_wandb=False, seed=0, device=device)
        b = len(batch["target_class"])
        with torch.no_grad():
            whole = trainer.loss_fn(trainer._prepare(batch), True)[1]
            parts = [trainer.loss_fn(trainer._prepare(_rows(batch, i * b // n, (i + 1) * b // n)),
                                     True)[1] for i in range(n)]
    return max(abs(float(whole[k]) - sum(float(p[k]) for p in parts) / n)
               for k in ("fs_loss", "os_loss"))


def _rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def pair_checks(device: str = "cuda", backend: Optional[str] = "gloo", way: int = 4,
                skeleton_metric_atol: float = 2e-6) -> Dict:
    """The dp rgb certificate (synced BatchNorm), the dp skeleton certificate
    (parameters to JAX's 2e-6, losses to ``skeleton_metric_atol``) and the
    way-sharding certificate over two ranks of one group, started once (two
    ranks on one card: gloo with CUDA tensors)."""
    cases = {m: _dp_case(2, m) for m in ("rgb", "skeleton")}
    jobs = [(_rank_step, (cfg, batch, device, None, ("dp",), "replicated", None))
            for cfg, batch in cases.values()] + [(_rank_way, (way, device))]
    ranks = run_ranks(_rank_sequence, 2, device, TIMEOUT, jobs, backend=backend)
    out = {f"dp {m}": _judge_dp(one_device_step(cfg, batch, device), ranks[0][i], m, 2,
                                metric_atol=skeleton_metric_atol)
           for i, (m, (cfg, batch)) in enumerate(cases.items())}
    out["way"] = _judge_way([r[2] for r in ranks])
    return out


def ci_stream_pipe(spec: Dict, device: str = "cpu", cuda_graphs: Optional[bool] = None):
    """A skeleton FusedPipeline at the CI size (120x160 BGR frames,
    EfficientNetV2-tiny, YOLO width 0.25 at 128, gate 0.0, float32, focus
    off) from ``spec``: {"hpe", "ar"} Flax variables (numpy leaves),
    "ar_config" and "support" (``ActionRecognizer.train`` items)."""
    from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer
    from isbfsar_tpu_torch.configs import CameraIntrinsics, HPEConfig, MainConfig, PipelineConfig
    from isbfsar_tpu_torch.hpe.estimator import HumanPoseEstimator
    from isbfsar_tpu_torch.models.effnetv2 import V2_TINY
    from isbfsar_tpu_torch.pipeline import FusedPipeline

    h, w = 120, 160
    hpe_cfg = HPEConfig(yolo_input_size=128, crop_size=256, yolo_thresh=0.0,
                        compute_dtype="float32")
    intr = CameraIntrinsics(width=w, height=h)
    hpe = HumanPoseEstimator(hpe_cfg, intr, params=spec["hpe"], backbone_stages=V2_TINY,
                             frame_shape=(h, w), yolo_width=0.25, device=device)
    ar = ActionRecognizer(spec["ar_config"], params=spec["ar"], device=device)
    for item in spec["support"]:
        ar.train(item)
    cfg = PipelineConfig(main=MainConfig(cam_width=w, cam_height=h), intrinsics=intr, hpe=hpe_cfg,
                         ar=spec["ar_config"], param_dtype="float32")
    return FusedPipeline(cfg, hpe=hpe, ar=ar, with_focus=False, input_format="bgr",
                         device=device, cuda_graphs=cuda_graphs)


def _rank_streams(spec: Dict, n_streams: int, mesh_shape, axes, way_axis, ticks, device: str,
                  cuda_graphs: Optional[bool], batch: int) -> Dict:
    """One rank of :func:`streams_over_ranks`."""
    from isbfsar_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from isbfsar_tpu_torch.serving import MultiStreamPipeline

    mesh = (make_mesh(axis=axes[0], device=device) if mesh_shape is None
            else make_mesh_2d(mesh_shape, axes, device))
    from isbfsar_tpu_torch.pipeline import FusedPipeline

    pipe = ci_stream_pipe(spec, device, cuda_graphs)
    multi = MultiStreamPipeline(n_streams=n_streams, pipe=pipe, mesh=mesh, way_axis=way_axis)
    multi.start()
    out = {"steps": [multi.step(t) for t in ticks]}
    multi.start()
    out["batched"] = list(multi.stream_batched(iter(ticks), batch_size=batch))
    out.update(streams=(multi.streams.start, multi.streams.stop),
               support_rows=int(multi._support_kv[0].shape[0]),
               pipe_support_kv=getattr(pipe, "_support_kv", None) is not None)
    if pipe.cuda_graphs:  # the graphs' oracle: the same nets stepped eagerly
        eager = FusedPipeline(pipe.config, hpe=pipe.hpe, ar=pipe.ar, with_focus=False,
                              input_format="bgr", device=device, cuda_graphs=False)
        twin = MultiStreamPipeline(n_streams=n_streams, pipe=eager, mesh=mesh, way_axis=way_axis)
        twin.start()
        out["eager_steps"] = [twin.step(t) for t in ticks]
    return out


def streams_over_ranks(spec: Dict, n_streams: int, ticks, n_ranks: int, mesh_shape=None,
                       axes=("dp",), way_axis: Optional[str] = None, device: str = "cpu",
                       backend: Optional[str] = None, cuda_graphs: Optional[bool] = None,
                       batch: int = 2):
    """Every rank's outputs of ``MultiStreamPipeline`` over a mesh of
    ``n_ranks`` (:func:`ci_stream_pipe` on each): ``step`` over ``ticks``
    (each (S, H, W, 3)), then ``stream_batched`` over them from a fresh
    start at ``batch``; with graphs, also an eager twin's ``step``s."""
    return run_ranks(_rank_streams, n_ranks, device, TIMEOUT, spec, n_streams, mesh_shape, axes,
                     way_axis, ticks, device, cuda_graphs, batch, backend=backend)


def _rank_flops(cfg: ARConfig, batch: Dict, device: str, mesh_shape, axes,
                seq_axis: Optional[str]) -> float:
    """One rank's FLOPs in one train step (``FlopCounterMode``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from isbfsar_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from isbfsar_tpu_torch.train.trainer import Trainer

    mesh = (make_mesh(axis=axes[0], device=device) if mesh_shape is None
            else make_mesh_2d(mesh_shape, axes, device))
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(cfg, log_dir=root, use_wandb=False, device=device, mesh=mesh,
                          seq_axis=seq_axis)
        prepared = trainer._prepare(batch)
        with FlopCounterMode(display=False) as counter:
            trainer._train_step(prepared, True)
    return float(counter.get_total_flops())


def flops_per_rank(modality: str, dp: int, device: str = "cpu") -> Dict[str, float]:
    """Rank 0's FLOPs in one train step of a ``dp``-episode batch on a dp
    mesh and on a dp x sp2 mesh: sequence parallelism's per-rank cut."""
    cfg = _cfg(modality, dp)
    batch = episodic_batch(cfg, dp, 32, modality, seed=0)
    f_dp = run_ranks(_rank_flops, dp, device, TIMEOUT, cfg, batch, device, None, ("dp",), None)
    f_sp = run_ranks(_rank_flops, 2 * dp, device, TIMEOUT, cfg, batch, device, (dp, 2),
                     ("dp", "sp"), "sp")
    return {"dp": f_dp[0], "sp": f_sp[0]}

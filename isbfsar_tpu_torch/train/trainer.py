"""Episodic trainer for the TRX-OS recognizer (port of
``isbfsar_tpu/train/trainer.py``, all three input modes, on one device or
over a mesh of ranks).

- loss = CE(few-shot logits) + BCE(discriminator, known episodes) +
  BCE(discriminator, unknown episodes). The discriminator trains only on
  episodes the few-shot head got right (``w = fs_correct``), and sample i's
  unknown episode counts iff sample i's known episode was right. The BCE
  clips its prediction to [1e-7, 1 - 1e-7] before the log, as the JAX code
  does (``F.binary_cross_entropy`` clamps the log at -100 instead).
- SGD with ``MultiStepLR``, whose milestones are counted in inner updates
  (:func:`milestone_boundaries`); duplicate milestones compound, so the
  defaults (first == second) drop the rate 100x at that epoch.
- Gradient accumulation as ``optax.MultiSteps`` does it: a running mean
  ``acc += (g - acc) / (mini_step + 1)``, an update only on the
  ``optimize_every``-th micro-step, and the counters ``mini_step``,
  ``gradient_step`` and the schedule's ``count`` kept as optax keeps them,
  so that a checkpoint written mid-accumulation resumes the same in either
  package.
- Every ``eval_every_n_epoch``-th epoch (epoch 0 included) validates and
  does not optimize; the discriminator trains from
  ``start_discriminator_after_epoch``.
- A checkpoint per training epoch, in the JAX trainer's layout
  (``{params, batch_stats, opt_state}``, :meth:`Trainer.state`).

One train step is one forward of the known episode, one of the unknown
episode against the known one's support features, and one backward.
In rgb and hybrid the ResNet-50's BatchNorm normalizes with batch
statistics in both forwards; the running averages then move by the known
episode's statistics (its query, then its support), and the unknown
episode's are dropped, as the JAX step keeps only the known ``apply``'s
``batch_stats``. Evaluation reads the running averages. ``cfg.remat``
recomputes the ResNet-50 per residual block in the backward pass.
Parameters, optimizer state and batches live on ``device``; on the card
float32 matmuls stay float32 (no TF32).

Over a ``mesh`` (``parallel/mesh.py``; one rank per device, each given the
whole host batch and keeping its own rows) the step is the 1-device step
of the whole batch:

- ``param_sharding="replicated"``: DDP over the ranks (its hooks fire on
  ``.backward()``, so the step calls that and reads ``p.grad``; the
  discriminator is unused before its epoch, hence
  ``find_unused_parameters``). ``"fsdp"``: FSDP2 ``fully_shard`` over
  ``dp``. ``"tp"``: tensor parallelism over a ``tp`` axis, with the
  gradients averaged over ``dp`` after the backward.
- ``seq_axis``: each rank of an ``sp`` group embeds its L/sp slice of every
  clip (the support in the way-minor (b, L, way) layout, as JAX's
  ``_sp_forward``), and the features are gathered along L before the
  transformer; the sp ranks of one dp slice compute the same loss.
- The BatchNorms of every train-mode forward take their statistics over
  the dp (and sp) ranks (``models/layers.py::sync_batch_stats``);
  ``sync_batchnorm=False`` turns that off, for the negative control only.
- The open-set terms divide by the dp-global count of correct episodes and
  gate on the global ``any_correct``, each rank's term scaled by the dp
  size so that the mean over the ranks is JAX's global loss.
- ``run_epoch`` gathers the episodes' metrics over dp, so the summaries are
  the 1-device ones; ``state()`` holds full tensors, and only rank 0
  writes checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import (float32_device, init_random, sync_batch_stats,
                                             update_running_stats)
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.parallel.collectives import gather_cat
from isbfsar_tpu_torch.train.dataloader import batch_iterator
from isbfsar_tpu_torch.utils import checkpoint as ckpt
from isbfsar_tpu_torch.utils.metrics import MetricsLogger, binary_prf
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables

CLIP_KEYS = ("support_set", "target_set", "unknown_set")
# the per-episode metrics run_epoch gathers over dp
EPISODE_KEYS = ("fs_correct", "os_weights", "os_known_pred", "os_unknown_pred")


@dataclasses.dataclass
class StepGroups:
    """The process groups one rank's step reduces over (all None: one device).

    ``dp_group``/``dp``: the ranks that hold other episodes of the batch;
    ``sp_group``: the ranks that hold other frames of the same episodes;
    ``bn_group``: the ranks whose BatchNorms share their statistics."""

    dp_group: Any = None
    dp: int = 1
    sp_group: Any = None
    bn_group: Any = None


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def make_loss_fn(model: TRXOS, cfg: ARConfig, groups: Optional[StepGroups] = None):
    """``loss_fn(batch, disc_on, train=True, stats=None) -> (total,
    metrics)`` on a prepared batch (tensors on the model's device);
    gradients flow into ``model``. ``train`` normalizes with batch
    statistics (JAX's ``train``); the known episode's are appended to
    ``stats`` if it is a list, the unknown episode's are not kept.
    ``groups`` (default: one device) makes the batch this rank's share of
    one split over ranks (:class:`Trainer`)."""
    g = groups or StepGroups()

    def extract(data, train, stats):
        """Features of clips whose time axis (dim 1) may be this rank's
        slice: gathered along it over the sp ranks."""
        feats = model.extract_features(data, train, stats)
        return feats if g.sp_group is None else gather_cat(feats, 1, g.sp_group)

    def loss_fn(batch: Dict, disc_on: bool, train: bool = True, stats: Optional[list] = None):
        b = batch["target_class"].shape[0]
        mask = torch.ones((b, cfg.way), dtype=torch.bool, device=batch["target_class"].device)
        if g.sp_group is None:
            out = model(batch["target_set"], mask, support_data=batch["support_set"],
                        train=train, stats=stats)
        else:
            # query, then the support in the way-minor layout, as JAX's _sp_forward
            q_feats = extract(batch["target_set"], train, stats)
            support = {m: v.transpose(1, 2) for m, v in batch["support_set"].items()}
            s_feats = extract(support, train, stats).transpose(1, 2)
            out = model.match_with_features(q_feats, mask, s_feats)
        logits = out["logits"]
        target = (batch["support_classes"] == batch["target_class"][:, None]).to(torch.float32)

        fs_loss = torch.mean(-torch.sum(target * F.log_softmax(logits, dim=-1), dim=-1))
        fs_correct = logits.argmax(dim=1) == target.argmax(dim=1)
        metrics: Dict[str, Any] = {"fs_loss": fs_loss, "fs_correct": fs_correct}
        total = fs_loss

        if disc_on:
            w = fs_correct.to(torch.float32)  # the discriminator trains where FS was right
            n_all = w.sum()
            if g.dp_group is not None:  # the count over the whole batch
                n_all = n_all.detach().clone()
                dist.all_reduce(n_all, group=g.dp_group)
            # each dp rank's share, scaled so that the mean over the ranks
            # divides the batch's sum by the batch's count
            n = torch.clamp(n_all, min=1.0) / g.dp
            known_pred = out["is_true"][:, 0]
            known_os = torch.sum(_bce(known_pred, torch.ones_like(known_pred)) * w) / n
            if g.sp_group is None:
                out_u = model(batch["unknown_set"], mask,
                              support_features=out["support_features"], train=train)
            else:
                out_u = model.match_with_features(extract(batch["unknown_set"], train, None),
                                                  mask, out["support_features"])
            unk_pred = out_u["is_true"][:, 0]
            unknown_os = torch.sum(_bce(unk_pred, torch.zeros_like(unk_pred)) * w) / n

            any_correct = n_all > 0
            zero = torch.zeros_like(fs_loss)
            total = total + torch.where(any_correct, known_os + unknown_os, zero)
            metrics.update(
                os_loss=torch.where(any_correct, 0.5 * (known_os + unknown_os), zero),
                os_weights=w,
                # copies, not views of the outputs (FSDP2 hooks a module's view outputs)
                os_known_pred=known_pred.detach().clone(),
                os_unknown_pred=unk_pred.detach().clone(),
            )
        return total, metrics

    return loss_fn


class _Episode(nn.Module):
    """The loss as one module call: DDP and FSDP2 work through a module's
    forward, and the step's is this one."""

    def __init__(self, model: TRXOS, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch: Dict, disc_on: bool, train: bool = True,
                stats: Optional[list] = None):
        return self.loss_fn(batch, disc_on, train, stats)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A whole tensor from a sharded one (a collective: every rank calls it)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a whole tensor into ``dst``, or into its shard where it is one."""
    if hasattr(dst, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        src = distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh, dst.placements)
    dst.copy_(src)


def milestone_boundaries(config, inner_per_epoch: int) -> Dict[int, float]:
    """Learning-rate drops in inner-update units: {step: factor}. Each listed
    milestone applies 0.1 once, so first == second (the defaults) is a 100x
    drop at that epoch."""
    boundaries: Dict[int, float] = {}
    for milestone in (config.first_milestone, config.second_milestone):
        step = milestone * inner_per_epoch
        boundaries[step] = boundaries.get(step, 1.0) * 0.1
    return boundaries


class Trainer:
    def __init__(
        self,
        config: ARConfig,
        train_sampler=None,
        valid_sampler=None,
        log_dir: str = "runs/trx",
        seed: int = 0,
        use_wandb: bool = True,
        param_sharding: str = "replicated",
        seq_axis: Optional[str] = None,
        device: str = "cuda",
        mesh=None,
        sync_batchnorm: bool = True,
    ):
        """mesh: a ``DeviceMesh`` with a ``dp`` axis (and ``tp`` for
        ``param_sharding="tp"``, ``seq_axis`` for sequence parallelism); None
        trains on ``device`` alone, and then no sharding can be asked for."""
        if param_sharding not in ("replicated", "fsdp", "tp"):
            raise ValueError(f"param_sharding: {param_sharding!r} not in "
                             f"('replicated', 'fsdp', 'tp')")
        if mesh is None and (param_sharding != "replicated" or seq_axis is not None):
            raise ValueError(
                f"param_sharding={param_sharding!r}, seq_axis={seq_axis!r} need a mesh "
                "with a 'dp' axis and the axis named (build one with parallel/mesh.py::"
                "make_mesh or make_mesh_2d((dp, n), ('dp', 'tp' or 'sp')))")
        axes = tuple(mesh.mesh_dim_names) if mesh is not None else ()
        if mesh is not None and "dp" not in axes:
            raise ValueError(f"mesh axes {axes} have no 'dp' axis")
        if param_sharding == "tp" and "tp" not in axes:
            raise ValueError(f"param_sharding='tp' needs a mesh with a 'tp' axis (got {axes}); "
                             "build one with make_mesh_2d((dp, tp), ('dp', 'tp'))")
        if seq_axis is not None:
            if seq_axis not in axes:
                raise ValueError(f"seq_axis={seq_axis!r} not in mesh axes {axes}; build one "
                                 "with make_mesh_2d((dp, sp), ('dp', 'sp'))")
            sp = mesh.size(axes.index(seq_axis))
            if config.seq_len % sp:
                raise ValueError(f"seq_len={config.seq_len} not divisible by the "
                                 f"{seq_axis!r} mesh axis ({sp})")
        self.cfg = config
        self.device = float32_device(device)
        self.mesh = mesh
        self.param_sharding = param_sharding
        self.seq_axis = seq_axis
        self.is_main = mesh is None or dist.get_rank() == 0
        self.train_sampler = train_sampler
        self.valid_sampler = valid_sampler
        self.logger = MetricsLogger(log_dir, use_wandb=use_wandb) if self.is_main else None
        self.ckpt_dir = config.checkpoint_dir or f"{log_dir}/checkpoints"

        self.model = TRXOS(config)
        init_random(self.model, torch.Generator().manual_seed(seed))
        # compute_dtype float64 trains in float64 throughout (parity checks)
        self.model.to(self.device, torch.float64 if config.compute_dtype == "float64"
                      else torch.float32)
        self.groups = self._groups(sync_batchnorm)
        sync_batch_stats(self.model, self.groups.bn_group)
        self.loss_fn = make_loss_fn(self.model, config, self.groups)
        self.episode = self._wrap(_Episode(self.model, self.loss_fn))
        self.names = [n for n, _ in self.model.named_parameters()]
        self.leaves = [p for _, p in self.model.named_parameters()]

        steps_per_epoch = max(1, config.n_task // config.batch_size)
        # the schedule counts inner updates, one per `optimize_every` micro-steps
        inner_per_epoch = max(1, steps_per_epoch // max(1, config.optimize_every))
        self.boundaries = milestone_boundaries(config, inner_per_epoch)
        # DTensor and plain leaves side by side (tp) cannot share one foreach kernel
        self.optimizer = torch.optim.SGD(self.leaves, lr=config.initial_lr,
                                         foreach=False if mesh is not None else None)
        # MultiStepLR applies gamma once per listed milestone, duplicates included
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, gamma=0.1, milestones=[
                m * inner_per_epoch for m in (config.first_milestone, config.second_milestone)])
        self.every = max(1, config.optimize_every)
        self.acc_grads = [torch.zeros_like(p) for p in self.leaves]
        self.mini_step = 0
        self.gradient_step = 0

    # ------------------------------------------------------------ placement

    def _axis(self, name: str):
        """(group, size) of a mesh axis."""
        return self.mesh.get_group(name), self.mesh.size(self.mesh.mesh_dim_names.index(name))

    def _groups(self, sync_batchnorm: bool) -> StepGroups:
        if self.mesh is None:
            return StepGroups()
        dp_group, dp = self._axis("dp")
        groups = StepGroups(dp_group=dp_group, dp=dp)
        if self.seq_axis is not None:
            groups.sp_group = self._axis(self.seq_axis)[0]
        # every rank makes the same new groups, in one order, and only those
        # its step uses: DDP's gradients and the BatchNorm sums over all
        # ranks each get their own, apart from the mesh's
        world = list(range(dist.get_world_size()))
        self._grad_world = dist.new_group(world) if self.param_sharding == "replicated" else None
        if sync_batchnorm:
            # tp ranks hold the same episodes: statistics over dp only
            groups.bn_group = (dp_group if self.param_sharding == "tp"
                               else dist.new_group(world))
        return groups

    def _wrap(self, episode: _Episode) -> nn.Module:
        """The episode under the asked sharding."""
        if self.mesh is None:
            return episode
        if self.param_sharding == "replicated":
            from torch.nn.parallel import DistributedDataParallel

            ids = [self.device.index or 0] if self.device.type == "cuda" else None
            return DistributedDataParallel(episode, device_ids=ids, process_group=self._grad_world,
                                           find_unused_parameters=True, broadcast_buffers=False)
        from isbfsar_tpu_torch.parallel.mesh import replicate, shard_params_fsdp, shard_params_tp

        # one init on every rank, rank 0's, as DDP's construction makes it
        replicate(list(self.model.parameters()) + list(self.model.buffers()), self.mesh)
        if self.param_sharding == "fsdp":
            return shard_params_fsdp(episode, self.mesh, "dp")
        shard_params_tp(self.model, self.mesh, "tp")
        return episode

    def _reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """The averages the wrapper leaves to the step: over dp under tp, over
        sp under fsdp (each rank's FSDP group is its dp slice)."""
        if self.mesh is None or self.param_sharding == "replicated":
            return
        if self.param_sharding == "tp":
            group, n = self._axis("dp")
        elif self.seq_axis is not None:
            group, n = self._axis(self.seq_axis)
        else:
            return
        if n == 1:
            return
        for grad in grads:
            local = getattr(grad, "_local_tensor", grad)
            dist.all_reduce(local, group=group)
            local.div_(n)

    # ------------------------------------------------------------- the step

    def _train_step(self, batch: Dict, disc_on: bool) -> Dict:
        stats: list = []
        total, metrics = self.episode(batch, disc_on, True, stats)
        # .backward() fires DDP's and FSDP's gradient reductions
        total.backward()
        # the discriminator is unused before it trains: its gradient is zero, as in JAX
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.leaves]
        for p in self.leaves:
            p.grad = None
        self._reduce_grads(grads)
        update_running_stats(stats)
        with torch.no_grad():
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            if self.mini_step == self.every - 1:
                for p, acc in zip(self.leaves, self.acc_grads):
                    p.grad = acc
                self.optimizer.step()
                self.scheduler.step()
                self.optimizer.zero_grad(set_to_none=True)
                for acc in self.acc_grads:
                    acc.zero_()
                self.gradient_step += 1
            self.mini_step = (self.mini_step + 1) % self.every
        return metrics

    def step(self, batch: Dict, disc_on: bool = True) -> Dict:
        """One train step on a loader batch (numpy; over a mesh the whole
        batch, of which this rank keeps its share); returns its metrics as
        tensors on the device, this rank's episodes only."""
        return self._train_step(self._prepare(batch), disc_on)

    def _eval_step(self, batch: Dict, disc_on: bool) -> Dict:
        with torch.no_grad():
            return self.episode(batch, disc_on, False)[1]

    def _global_metrics(self, metrics: Dict) -> Dict:
        """A step's metrics over the whole batch: the losses averaged over
        dp, the episodes' values gathered in rank order."""
        g = self.groups
        if g.dp_group is None:
            return metrics
        losses = [k for k in ("fs_loss", "os_loss") if k in metrics]
        scalars = torch.stack([metrics[k].detach() for k in losses])
        dist.all_reduce(scalars, group=g.dp_group)
        out = {k: scalars[i] / g.dp for i, k in enumerate(losses)}
        keys = [k for k in EPISODE_KEYS if k in metrics]
        rows = torch.stack([metrics[k].detach().to(scalars.dtype) for k in keys], dim=1)
        parts = [torch.empty_like(rows) for _ in range(g.dp)]
        dist.all_gather(parts, rows.contiguous(), group=g.dp_group)
        rows = torch.cat(parts)
        for i, k in enumerate(keys):
            out[k] = rows[:, i] > 0.5 if k == "fs_correct" else rows[:, i]
        return out

    # ----------------------------------------------------------------- loop

    def run_epoch(self, epoch: int, batches: Iterable[Dict], train: bool) -> Dict[str, float]:
        disc_on = epoch > self.cfg.start_discriminator_after_epoch - 1
        steps: List[Dict] = []
        for batch in batches:
            metrics = (self.step(batch, disc_on) if train
                       else self._eval_step(self._prepare(batch), disc_on))
            metrics = self._global_metrics({k: v.detach() for k, v in metrics.items()})
            steps.append(metrics)
        steps = [{k: v.cpu().numpy() for k, v in m.items()} for m in steps]  # one wait

        fs_losses = [float(m["fs_loss"]) for m in steps]
        fs_correct = [m["fs_correct"] for m in steps]
        os_losses: List[float] = []
        os_true: List[np.ndarray] = []
        os_pred: List[np.ndarray] = []
        if disc_on:
            for m in steps:
                os_losses.append(float(m["os_loss"]))
                w = m["os_weights"] > 0
                os_true.append(np.ones(int(w.sum())))
                os_pred.append((m["os_known_pred"][w] > 0.5).astype(float))
                os_true.append(np.zeros(int(w.sum())))
                os_pred.append((m["os_unknown_pred"][w] > 0.5).astype(float))

        os_true_all = np.concatenate(os_true) if os_true else np.zeros(1)
        os_pred_all = np.concatenate(os_pred) if os_pred else np.zeros(1)
        prf = binary_prf(os_true_all, os_pred_all)
        label = "train" if train else "valid"
        summary = {
            f"{label}/fs_loss": float(np.mean(fs_losses)) if fs_losses else 0.0,
            f"{label}/fs_accuracy": float(np.concatenate(fs_correct).mean()) if fs_correct else 0.0,
            f"{label}/os_loss": float(np.mean(os_losses)) if os_losses else 0.0,
            f"{label}/os_accuracy": prf["accuracy"],
            f"{label}/os_precision": prf["precision"],
            f"{label}/os_recall": prf["recall"],
            f"{label}/os_f1": prf["f1"],
        }
        if self.logger is not None:
            self.logger.log(summary, step=epoch)
        return summary

    def _prepare(self, batch: Dict) -> Dict:
        """A loader batch (numpy) -> tensors on the device; the unknown set
        defaults to the target set. Over a mesh only this rank's rows (and
        time slice) go to the device."""
        batch = {**batch, "unknown_set": batch.get("unknown_set", batch["target_set"])}
        batch = {k: batch[k] for k in CLIP_KEYS + ("support_classes", "target_class")}
        if self.mesh is not None:
            from isbfsar_tpu_torch.parallel.mesh import shard_batch, shard_batch_sp

            batch = (shard_batch(batch, self.mesh, "dp") if self.seq_axis is None
                     else shard_batch_sp(batch, self.mesh, "dp", self.seq_axis))
        dtype = np.float64 if self.cfg.compute_dtype == "float64" else np.float32
        out = {k: {m: to_device(np.asarray(v, dtype), self.device)
                   for m, v in batch[k].items()} for k in CLIP_KEYS}
        for k in ("support_classes", "target_class"):
            out[k] = to_device(np.asarray(batch[k], np.int32), self.device)
        return out

    # ------------------------------------------------------ state and files

    def _state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's parameters and running averages as whole tensors
        (gathered from their shards: every rank calls this)."""
        out = {name: _full(p.detach()) for name, p in zip(self.names, self.leaves)}
        for name, buf in self.model.state_dict().items():
            out.setdefault(name, buf)
        return out

    @property
    def params(self) -> Dict:
        """The parameters as the JAX trainer's Flax tree (CPU tensors)."""
        return to_flax_variables(self._state_dict())["params"]

    @property
    def batch_stats(self) -> Dict:
        """The rgb extractor's BatchNorm running averages as the JAX
        trainer's Flax tree (CPU tensors); empty in skeleton mode."""
        return to_flax_variables(self._state_dict()).get("batch_stats", {})

    def state(self) -> Dict:
        """``{params, batch_stats, opt_state}`` as the JAX trainer writes it:
        optax.MultiSteps' state around sgd's (EmptyState, schedule count),
        int32 counters and float32 leaves; whole tensors under any sharding
        (every rank calls this)."""
        acc = to_flax_variables({n: _full(a) for n, a in zip(self.names, self.acc_grads)})["params"]
        count = self.scheduler.last_epoch

        def i32(v):
            return torch.tensor(v, dtype=torch.int32)

        variables = to_flax_variables(self._state_dict())
        return {
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": {
                "mini_step": i32(self.mini_step),
                "gradient_step": i32(self.gradient_step),
                "inner_opt_state": {"0": {}, "1": {"count": i32(count)}},
                "acc_grads": acc,
                "skip_state": {},
            },
        }

    def load_state(self, state: Dict) -> None:
        """Adopt a checkpoint tree of either package ({params, batch_stats,
        opt_state}), onto this trainer's device and into its shards."""
        sd = convert_variables({"params": state["params"],
                                "batch_stats": state.get("batch_stats") or {}})
        if set(sd) != set(self.model.state_dict()):
            raise KeyError(f"checkpoint keys differ from the model's: "
                           f"{sorted(set(sd) ^ set(self.model.state_dict()))}")
        acc = convert_variables({"params": state["opt_state"]["acc_grads"]})
        with torch.no_grad():
            for name, p, buf in zip(self.names, self.leaves, self.acc_grads):
                _assign(p, sd[name])
                _assign(buf, acc[name])
            for name, b in self.model.named_buffers():
                if name in sd:
                    b.copy_(sd[name])
        opt = state["opt_state"]
        self.mini_step = int(opt["mini_step"])
        self.gradient_step = int(opt["gradient_step"])
        count = int(opt["inner_opt_state"]["1"]["count"])
        self.scheduler.last_epoch = count
        lr = self.cfg.initial_lr
        for step, factor in self.boundaries.items():
            lr *= factor if count >= step else 1.0
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def fit(self, n_epochs: Optional[int] = None, batches_fn=None) -> Dict[str, float]:
        """batches_fn(sampler, epoch) -> iterable of batches (injectable for tests)."""
        cfg = self.cfg
        n_epochs = n_epochs or cfg.n_epochs
        batches_fn = batches_fn or (
            lambda sampler, epoch: batch_iterator(sampler, cfg.batch_size, seed=epoch)
        )
        last = {}
        for epoch in range(n_epochs):
            do_eval = epoch % cfg.eval_every_n_epoch == 0 and self.valid_sampler is not None
            sampler = self.valid_sampler if do_eval else self.train_sampler
            last = self.run_epoch(epoch, batches_fn(sampler, epoch), train=not do_eval)
            if not do_eval:
                state = self.state()  # every rank: the shards are gathered
                if self.is_main:
                    ckpt.save_checkpoint(self.ckpt_dir, epoch, state, meta={"epoch": epoch},
                                         backend=cfg.ckpt_backend)
        return last

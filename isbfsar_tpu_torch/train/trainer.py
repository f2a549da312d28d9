"""Episodic trainer for the TRX-OS recognizer (port of
``isbfsar_tpu/train/trainer.py``, all three input modes, one device).

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
float32 matmuls stay float32 (no TF32). Parameter sharding and sequence
parallelism (ROADMAP A.17) are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from isbfsar_tpu_torch.configs import ARConfig
from isbfsar_tpu_torch.models.layers import float32_device, init_random, update_running_stats
from isbfsar_tpu_torch.models.trx import TRXOS
from isbfsar_tpu_torch.train.dataloader import batch_iterator
from isbfsar_tpu_torch.utils import checkpoint as ckpt
from isbfsar_tpu_torch.utils.metrics import MetricsLogger, binary_prf
from isbfsar_tpu_torch.utils.transfer import to_device
from isbfsar_tpu_torch.weights import convert_variables, to_flax_variables

CLIP_KEYS = ("support_set", "target_set", "unknown_set")


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    pred = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def make_loss_fn(model: TRXOS, cfg: ARConfig):
    """``loss_fn(batch, disc_on, train=True, stats=None) -> (total,
    metrics)`` on a prepared batch (tensors on the model's device);
    gradients flow into ``model``. ``train`` normalizes with batch
    statistics (JAX's ``train``); the known episode's are appended to
    ``stats`` if it is a list, the unknown episode's are not kept."""

    def loss_fn(batch: Dict, disc_on: bool, train: bool = True, stats: Optional[list] = None):
        b = batch["target_class"].shape[0]
        mask = torch.ones((b, cfg.way), dtype=torch.bool, device=batch["target_class"].device)
        out = model(batch["target_set"], mask, support_data=batch["support_set"], train=train,
                    stats=stats)
        logits = out["logits"]
        target = (batch["support_classes"] == batch["target_class"][:, None]).to(torch.float32)

        fs_loss = torch.mean(-torch.sum(target * F.log_softmax(logits, dim=-1), dim=-1))
        fs_correct = logits.argmax(dim=1) == target.argmax(dim=1)
        metrics: Dict[str, Any] = {"fs_loss": fs_loss, "fs_correct": fs_correct}
        total = fs_loss

        if disc_on:
            w = fs_correct.to(torch.float32)  # the discriminator trains where FS was right
            n = torch.clamp(w.sum(), min=1.0)
            known_pred = out["is_true"][:, 0]
            known_os = torch.sum(_bce(known_pred, torch.ones_like(known_pred)) * w) / n
            out_u = model(batch["unknown_set"], mask, support_features=out["support_features"],
                          train=train)
            unk_pred = out_u["is_true"][:, 0]
            unknown_os = torch.sum(_bce(unk_pred, torch.zeros_like(unk_pred)) * w) / n

            any_correct = w.sum() > 0
            zero = torch.zeros_like(fs_loss)
            total = total + torch.where(any_correct, known_os + unknown_os, zero)
            metrics.update(
                os_loss=torch.where(any_correct, 0.5 * (known_os + unknown_os), zero),
                os_weights=w,
                os_known_pred=known_pred,
                os_unknown_pred=unk_pred,
            )
        return total, metrics

    return loss_fn


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
    ):
        if param_sharding != "replicated":
            raise NotImplementedError(
                f"param_sharding={param_sharding!r}: the port trains on one device with "
                "replicated parameters; fsdp/tp become DDP/FSDP (ROADMAP A.17)")
        if seq_axis is not None:
            raise NotImplementedError(
                "seq_axis: sequence parallelism is not ported (DDP/FSDP, ROADMAP A.17)")
        self.cfg = config
        self.device = float32_device(device)
        self.train_sampler = train_sampler
        self.valid_sampler = valid_sampler
        self.logger = MetricsLogger(log_dir, use_wandb=use_wandb)
        self.ckpt_dir = config.checkpoint_dir or f"{log_dir}/checkpoints"

        self.model = TRXOS(config)
        init_random(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.leaves = [p for _, p in self.model.named_parameters()]

        steps_per_epoch = max(1, config.n_task // config.batch_size)
        # the schedule counts inner updates, one per `optimize_every` micro-steps
        inner_per_epoch = max(1, steps_per_epoch // max(1, config.optimize_every))
        self.boundaries = milestone_boundaries(config, inner_per_epoch)
        self.optimizer = torch.optim.SGD(self.leaves, lr=config.initial_lr)
        # MultiStepLR applies gamma once per listed milestone, duplicates included
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, gamma=0.1, milestones=[
                m * inner_per_epoch for m in (config.first_milestone, config.second_milestone)])
        self.every = max(1, config.optimize_every)
        self.acc_grads = [torch.zeros_like(p) for p in self.leaves]
        self.mini_step = 0
        self.gradient_step = 0
        self.loss_fn = make_loss_fn(self.model, config)

    # ------------------------------------------------------------- the step

    def _train_step(self, batch: Dict, disc_on: bool) -> Dict:
        stats: list = []
        total, metrics = self.loss_fn(batch, disc_on, stats=stats)
        # the discriminator is unused before it trains: its gradient is zero, as in JAX
        grads = torch.autograd.grad(total, self.leaves, allow_unused=True, materialize_grads=True)
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
        """One train step on a loader batch (numpy); returns its metrics as
        tensors on the device."""
        return self._train_step(self._prepare(batch), disc_on)

    def _eval_step(self, batch: Dict, disc_on: bool) -> Dict:
        with torch.no_grad():
            return self.loss_fn(batch, disc_on, train=False)[1]

    # ----------------------------------------------------------------- loop

    def run_epoch(self, epoch: int, batches: Iterable[Dict], train: bool) -> Dict[str, float]:
        disc_on = epoch > self.cfg.start_discriminator_after_epoch - 1
        steps: List[Dict] = []
        for batch in batches:
            metrics = (self.step(batch, disc_on) if train
                       else self._eval_step(self._prepare(batch), disc_on))
            steps.append({k: v.detach() for k, v in metrics.items()})
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
        self.logger.log(summary, step=epoch)
        return summary

    def _prepare(self, batch: Dict) -> Dict:
        """A loader batch (numpy) -> tensors on the device; the unknown set
        defaults to the target set."""
        batch = {**batch, "unknown_set": batch.get("unknown_set", batch["target_set"])}
        out = {k: {m: to_device(np.asarray(v, np.float32), self.device)
                   for m, v in batch[k].items()} for k in CLIP_KEYS}
        for k in ("support_classes", "target_class"):
            out[k] = to_device(np.asarray(batch[k], np.int32), self.device)
        return out

    # ------------------------------------------------------ state and files

    @property
    def params(self) -> Dict:
        """The parameters as the JAX trainer's Flax tree (CPU tensors)."""
        return to_flax_variables(self.model.state_dict())["params"]

    @property
    def batch_stats(self) -> Dict:
        """The rgb extractor's BatchNorm running averages as the JAX
        trainer's Flax tree (CPU tensors); empty in skeleton mode."""
        return to_flax_variables(self.model.state_dict()).get("batch_stats", {})

    def state(self) -> Dict:
        """``{params, batch_stats, opt_state}`` as the JAX trainer writes it:
        optax.MultiSteps' state around sgd's (EmptyState, schedule count),
        int32 counters and float32 leaves."""
        acc = to_flax_variables(dict(zip(self.names, self.acc_grads)))["params"]
        count = self.scheduler.last_epoch

        def i32(v):
            return torch.tensor(v, dtype=torch.int32)

        variables = to_flax_variables(self.model.state_dict())
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
        opt_state}), onto this trainer's device."""
        sd = convert_variables({"params": state["params"],
                                "batch_stats": state.get("batch_stats") or {}})
        self.model.load_state_dict(sd, strict=True)
        opt = state["opt_state"]
        acc = convert_variables({"params": opt["acc_grads"]})
        with torch.no_grad():
            for name, buf in zip(self.names, self.acc_grads):
                buf.copy_(acc[name])
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
                ckpt.save_checkpoint(self.ckpt_dir, epoch, self.state(), meta={"epoch": epoch},
                                     backend=cfg.ckpt_backend)
        return last

"""The synthetic trainers' optimizer: ``optax.chain(clip_by_global_norm(1.0),
adam(lr))``, written as optax computes it (optax 0.2); with ``max_norm=None``
plain ``optax.adam(lr)`` (the mutual-gaze trainer's).

* The clip: with ``norm = sqrt(sum over leaves of sum(g * g))``, every
  gradient becomes ``where(norm < max_norm, g, g / norm * max_norm)``.
  That is not ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the
  norm and multiplies by ``max_norm / (norm + 1e-6)``.
* Adam: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g * g + b2 * nu``,
  both divided by their bias corrections ``1 - b ** count``, and the update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` added to the parameter.

Every operation stays on the parameters' device (the clip is a ``where``,
not a branch on the host); the parameters share one floating type. A new optimizer starts with zero moments and a
count of 0, as a fresh ``optimizer.init`` does: a warm start keeps the
weights, not the moments.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class ClipAdam:
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 max_norm: Optional[float] = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (a missing one counts
        as zeros, as a leaf the loss does not reach has a zero gradient).
        Multi-tensor (``torch._foreach_*``) operations: a few launches a
        step, not a dozen per parameter."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.max_norm is not None:
            # the global norm: the square root of the sum of each leaf's sum of squares
            norm = torch.sqrt(sum(n * n for n in torch._foreach_norm(grads)))
            scaled = torch._foreach_div(grads, norm)
            torch._foreach_mul_(scaled, self.max_norm)
            grads = [torch.where(norm < self.max_norm, g, c) for g, c in zip(grads, scaled)]
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        # the bias corrections computed in the parameters' type, as optax
        # casts them, and passed as numbers (no copy to the device)
        dtype = self.params[0].dtype
        bc1 = float(1 - torch.tensor(self.b1, dtype=dtype) ** self.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=dtype) ** self.count)
        update = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update, alpha=-self.lr)

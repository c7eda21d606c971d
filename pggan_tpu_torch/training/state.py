"""Training state and the optimizer: the counterpart of
``pggan_tpu/training/state.py``.

``TrainState`` holds G, D, both Adam states, the device ``torch.Generator``
that draws latents and GP mixing factors, and the optional G EMA. The
clock (images seen, ticks) stays with the training loop, as in the JAX
package.

``Adam`` is optax's ``scale_by_adam`` (the bias-corrected direction) with
the learning rate applied per step as ``p - lr * direction``
(``state.py:36-61``), written out on ``torch._foreach_*`` ops and updating
the parameters in place. Defaults are the reference's
``Adam(betas=(0.0, 0.99))`` override (train.py:195) and eps 1e-8. Its step
count, the learning rate and both bias corrections live in device tensors
and are computed there, so a step captured into a CUDA graph reads them at
every replay instead of baking in the values of the step it recorded.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


class Adam:
    """Adam over a fixed list of tensors, with the lr given at each step."""

    def __init__(self, params, b1: float = 0.0, b2: float = 0.99,
                 eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        device = self.params[0].device
        # optax's count, int32; the lr a step was given, when it was a number
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self._lr = torch.zeros((), dtype=torch.float32, device=device)

    @torch.no_grad()
    def step(self, grads, lr) -> None:
        """``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
        ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)`` with the bias
        corrections ``1 - b^t`` taken in float32 on the device, as optax
        takes them. ``lr`` is a number or a 0-d float32 device tensor; a
        number is written into a device tensor first."""
        if not isinstance(lr, torch.Tensor):
            self._lr.fill_(float(lr))
            lr = self._lr
        self.count.add_(1)
        t = self.count.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, t)
        bc2 = 1.0 - torch.pow(self.b2, t)
        b1, b2 = self.b1, self.b2
        grads = list(grads)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(self.params, upd)


@dataclasses.dataclass
class TrainState:
    G: nn.Module
    D: nn.Module
    g_opt: Adam
    d_opt: Adam
    generator: torch.Generator  # on the device: latents, GP mixing factors
    g_ema: nn.Module | None = None  # EMA of G's parameters, or None


def init_state(G: nn.Module, D: nn.Module, seed: int = 0, *,
               g_ema: bool = False, b1: float = 0.0, b2: float = 0.99,
               eps: float = 1e-8) -> TrainState:
    """A fresh state on the device of G's parameters; ``g_ema=True`` starts
    the EMA as a copy of G."""
    device = next(G.parameters()).device
    return TrainState(
        G=G, D=D,
        g_opt=Adam(G.parameters(), b1, b2, eps),
        d_opt=Adam(D.parameters(), b1, b2, eps),
        generator=torch.Generator(device=device).manual_seed(seed),
        g_ema=copy.deepcopy(G).requires_grad_(False) if g_ema else None)

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

``scratch_copy`` makes a copy of a state that shares no tensor and no
generator with it: the precompile ahead of a stage (``steps.py``) warms a
step up on it, so that the real run, its generator's stream included, is
never touched.

Under data parallelism (``init_state(..., group=...)``) the parameters,
buffers and Adam states are replicated from rank 0, and each rank's
generator is seeded ``seed + rank``, as the JAX CLI seeds each process's
loader (``pggan_tpu/cli/train.py:347``): the ranks draw different latents.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from pggan_tpu_torch.parallel import replicate


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

    def tensors(self) -> list:
        """Every tensor that the ranks of a data-parallel run hold alike:
        both models' parameters and buffers, both Adam states, the EMA."""
        out = []
        for module in (self.G, self.D, self.g_ema):
            if module is not None:
                out += [*module.parameters(), *module.buffers()]
        for opt in (self.g_opt, self.d_opt):
            out += [*opt.mu, *opt.nu, opt.count]
        return out


def init_state(G: nn.Module, D: nn.Module, seed: int = 0, *,
               g_ema: bool = False, b1: float = 0.0, b2: float = 0.99,
               eps: float = 1e-8, group=None) -> TrainState:
    """A fresh state on the device of G's parameters; ``g_ema=True`` starts
    the EMA as a copy of G. With ``group`` (a ``parallel.Group``) the
    generator is seeded ``seed + rank`` and the rest is replicated from
    rank 0."""
    device = next(G.parameters()).device
    rank = 0 if group is None else group.rank
    state = TrainState(
        G=G, D=D,
        g_opt=Adam(G.parameters(), b1, b2, eps),
        d_opt=Adam(D.parameters(), b1, b2, eps),
        generator=torch.Generator(device=device).manual_seed(seed + rank),
        g_ema=copy.deepcopy(G).requires_grad_(False) if g_ema else None)
    if group is not None:
        replicate(state.tensors())
    return state


def _copy_adam(opt: Adam, params) -> Adam:
    new = copy.copy(opt)
    new.params = list(params)
    new.mu = [t.clone() for t in opt.mu]
    new.nu = [t.clone() for t in opt.nu]
    new.count, new._lr = opt.count.clone(), opt._lr.clone()
    return new


def scratch_copy(state: TrainState) -> TrainState:
    """A copy of ``state`` on its device: both models (parameters and
    buffers), both Adams, the EMA and a generator of its own that starts
    where the state's stands. Nothing in it aliases ``state``. On the card
    the copies are made on the current stream. The copy's D has no process
    group: its minibatch stddev takes the rank's batch alone."""
    G = copy.deepcopy(state.G)
    D = copy.deepcopy(state.D)
    D.group = None
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return TrainState(
        G=G, D=D,
        g_opt=_copy_adam(state.g_opt, G.parameters()),
        d_opt=_copy_adam(state.d_opt, D.parameters()),
        generator=gen,
        g_ema=None if state.g_ema is None else copy.deepcopy(state.g_ema))

"""The WGAN-GP train step: the counterpart of
``pggan_tpu/training/steps.py::_raw_step``.

One step is the reference's hot loop (trainer.py:85-115): for each of
``d_training_repeats`` real batches, the D loss with its gradient penalty
(a double backward through D's kernels) and an Adam update of D; then the
G loss through the updated D and an Adam update of G; then the optional G
EMA.

On the card the step of each (depth, batch, fade) becomes a CUDA graph,
the counterpart of the JAX package's one compiled program per key that the
trainer dispatches once a step (``steps.py:252-261``). Its first call runs
eagerly: a real step that also warms cuDNN's plans, the allocator and the
kernel library. Its second call captures the step into a
``torch.cuda.CUDAGraph`` (a capture records the work without running it)
and replays it; later calls copy their inputs into the graph's static
tensors and replay. So a replayed step is one launch from Python instead
of some three thousand. Everything a replay must read afresh is a device
tensor: the reals, alpha and both learning rates (static inputs), Adam's
step count and bias corrections (``state.py``), and the state's
``torch.Generator``, registered with the graph so that every replay draws
new latents and mixing factors. All graphs share one memory pool: they
never run at once. A capture that fails raises; nothing falls back to the
eager route, which stays reachable as ``TrainStepBuilder(...,
cuda_graphs=False)``. On the CPU every step is eager.

Random draws come in the JAX step's order: per D repeat the latents and
then the GP mixing factors, then G's latents (``steps.py:129-131,152-153``,
``losses.py:74``). They come from a ``noise(kind, shape)`` hook, ``kind``
``"normal"`` or ``"uniform"``; by default it draws from the state's device
``torch.Generator``. Tests pass in the JAX step's own draws.

TF32 is switched off when the builder is made: cuDNN's convolutions (the
low-resolution stages) default to it on the card.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from pggan_tpu_torch.losses import wgan_gp_D_loss, wgan_gp_G_loss
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops.primitives import f32_scalar
from pggan_tpu_torch.sampling import disable_tf32
from pggan_tpu_torch.training.state import TrainState


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """D's parameters need no gradient while G's loss is differentiated:
    the kernels' Functions then skip D's weight gradients."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def _grads(loss, params):
    """Gradients of ``loss``; zeros for the parameters of the stages that
    the step's depth does not reach, as ``jax.grad`` gives them."""
    return torch.autograd.grad(loss, params, allow_unused=True,
                               materialize_grads=True)


def _default_noise(state: TrainState):
    """Draws from the state's device generator."""
    def noise(kind: str, shape) -> torch.Tensor:
        gen = state.generator
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=gen.device)
        if kind == "uniform":
            return torch.rand(shape, generator=gen, device=gen.device)
        raise ValueError(f"unknown noise kind {kind!r}")
    return noise


def _set(static: torch.Tensor, value) -> None:
    """Write a step input into its static tensor: a tensor by a copy, a
    number by a fill on the device."""
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        static.fill_(float(value))


class _GraphedStep:
    """One (depth, batch, fade) step on the card: eager on its first call,
    captured into a CUDA graph and replayed on its second, replayed after.
    The graph is bound to the state of the first call and returns the same
    static metric tensors at every replay, which the next replay
    overwrites: clone what must outlive it."""

    def __init__(self, raw, builder):
        self.raw, self.builder = raw, builder
        self.state = None
        self.warm = False  # the eager first call has run
        self.graph = None
        self.out = None  # the graph's static metrics
        self.capture_s = None  # host seconds of the capture
        self.captured = None  # kernel wrapper calls recorded, by kernel
        self.replays = 0

    def __call__(self, state, reals, alpha, lr_d, lr_g, noise=None):
        if reals.device.type != "cuda":
            return self.raw(state, reals, alpha, lr_d, lr_g, noise)
        if noise is not None:
            raise ValueError("a graphed step draws from the state's "
                             "generator; pass noise to the eager route "
                             "(TrainStepBuilder(..., cuda_graphs=False))")
        if self.state is None:
            self.state = state
            self.reals = torch.empty_like(reals)
            self.scalars = torch.zeros(3, dtype=torch.float32,
                                       device=reals.device)
        elif state is not self.state:
            raise ValueError("this graphed step is bound to the state of its "
                             "first call")
        if reals.shape != self.reals.shape:
            raise ValueError(f"reals {tuple(reals.shape)}, expected "
                             f"{tuple(self.reals.shape)}")
        self.reals.copy_(reals)
        for static, value in zip(self.scalars, (alpha, lr_d, lr_g)):
            _set(static, value)
        args = (state, self.reals, *self.scalars)
        if self.graph is None:
            if not self.warm:
                self.warm = True  # the first call: a real, eager step
                return self.raw(*args)
            self.graph = self._capture(args)
        self.graph.replay()
        self.replays += 1
        return self.out

    def _capture(self, args):
        state = args[0]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        torch.cuda.synchronize()
        before = collections.Counter(_build.CAPTURED)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.builder.graph_pool()):
            self.out = self.raw(*args)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.captured = _build.CAPTURED - before
        return graph


class TrainStepBuilder:
    """Train steps for (depth, batch_size, fade), the input prep and the
    sampling function."""

    def __init__(self, G, D, d_training_repeats: int = 1,
                 iwass_lambda: float = 10.0, iwass_epsilon: float = 0.001,
                 iwass_target: float = 1.0, g_ema_beta: float | None = None,
                 cuda_graphs: bool = True):
        if G.inference_chain:
            raise ValueError("train with inference_chain=False: the chain "
                             "kernel is forward-only")
        self.G, self.D = G, D
        self.d_training_repeats = int(d_training_repeats)
        self.iwass_lambda = float(iwass_lambda)
        self.iwass_epsilon = float(iwass_epsilon)
        self.iwass_target = float(iwass_target)
        self.g_ema_beta = (None if g_ema_beta is None or g_ema_beta <= 0
                           else float(g_ema_beta))
        self.cuda_graphs = bool(cuda_graphs)
        self._steps: dict = {}
        self._pool = None
        disable_tf32()

    def graphed_keys(self) -> list:
        """The (depth, batch, fade) keys whose step has been captured."""
        return sorted(k for k, s in self._steps.items()
                      if getattr(s, "graph", None) is not None)

    def graph_pool(self):
        """The memory pool that every graph of this builder shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def step_fn(self, depth: int, batch_size: int, fade: bool = True):
        """``step(state, reals, alpha, lr_d, lr_g, noise=None) -> metrics``:
        reals (R, B, H, W, C) f32 on the device; alpha and the learning
        rates numbers or 0-d float32 device tensors; the metrics are the
        device scalars ``G_loss``, ``D_loss``, ``D_real``, ``D_fake`` of the
        last D repeat (``steps.py:177-184``). Updates ``state`` in place.
        With ``cuda_graphs`` a CUDA state's step is graphed (see the module
        docstring): its metrics are overwritten by its next call."""
        key = (depth, batch_size, fade)
        if key not in self._steps:
            raw = self._raw_step(depth, batch_size, fade)
            self._steps[key] = (_GraphedStep(raw, self) if self.cuda_graphs
                                else raw)
        return self._steps[key]

    def _raw_step(self, depth: int, batch_size: int, fade: bool):
        """The eager step that ``step_fn`` runs or captures."""
        lam, drift, target = (self.iwass_lambda, self.iwass_epsilon,
                              self.iwass_target)
        repeats, beta = self.d_training_repeats, self.g_ema_beta

        def step(state: TrainState, reals, alpha, lr_d, lr_g, noise=None):
            G, D = state.G, state.D
            if reals.shape[0] != repeats or reals.shape[1] != batch_size:
                raise ValueError(f"reals {tuple(reals.shape)}, expected "
                                 f"({repeats}, {batch_size}, ...)")
            if beta is not None and state.g_ema is None:
                raise ValueError("g_ema_beta is set but the state has no G "
                                 "EMA: init_state(..., g_ema=True)")
            noise = noise or _default_noise(state)
            latent = (batch_size, G.latent_size)

            def d_fn(x):
                return D(x, depth, alpha, fade)

            def d_pair_fn(x2):
                return D(x2, depth, alpha, fade, stat_groups=2)

            def g_fn(z):
                return G(z, depth, alpha, fade)

            d_params = list(D.parameters())
            for r in range(repeats):
                z = noise("normal", latent)
                mix = noise("uniform", (batch_size,))
                d_cost, (d_real, d_fake) = wgan_gp_D_loss(
                    d_fn, g_fn, reals[r], z, mix, lam, drift, target,
                    d_pair_fn=d_pair_fn)
                grads = _grads(d_cost, d_params)
                state.d_opt.step(grads, lr_d)

            z = noise("normal", latent)
            with _frozen(D):
                g_cost = wgan_gp_G_loss(g_fn, d_fn, z)
                g_params = list(G.parameters())
                g_grads = _grads(g_cost, g_params)
            state.g_opt.step(g_grads, lr_g)

            if beta is not None:
                with torch.no_grad():
                    torch._foreach_lerp_(list(state.g_ema.parameters()),
                                         g_params, 1.0 - beta)
            return {"G_loss": g_cost.detach(), "D_loss": d_cost.detach(),
                    "D_real": d_real.detach(), "D_fake": d_fake.detach()}

        return step

    def real_batch_shape(self, depth: int, batch_size: int) -> tuple:
        """NHWC shape of one step's reals: (R, B, H, W, C)."""
        res = 4 * 2 ** depth
        return (self.d_training_repeats, batch_size, res, res,
                self.G.num_channels)

    def prep_fn(self, range_in=(0, 255), range_out=(-1, 1)):
        """``prep(u8 (..., H, W, C), alpha) -> f32``: cast, the fade's 2x2
        box blend (reference dataset.py:109-113) and the dynamic-range remap,
        on the tensor's device (``steps.py:302-336``). ``alpha`` is a scalar
        or a vector over the leading axis."""
        min_in, max_in = range_in
        min_out, max_out = range_out
        scale = (max_out - min_out) / (max_in - min_in)

        def prep(u8: torch.Tensor, alpha) -> torch.Tensor:
            x = u8.to(torch.float32)
            *lead, h, w, c = x.shape
            blocks = (*lead, h // 2, 2, w // 2, 2, c)
            t = x.reshape(blocks).mean(dim=(-4, -2), keepdim=True)
            t = t.expand(blocks).reshape(x.shape)
            alpha = (f32_scalar(alpha, x.device) if np.ndim(alpha) == 0
                     else torch.as_tensor(alpha, dtype=torch.float32,
                                          device=x.device))
            alpha = alpha.reshape(alpha.shape + (1,) * (x.ndim - alpha.ndim))
            x = x * alpha + t * (1.0 - alpha)
            return (x - min_in) * scale + min_out

        return prep

    def sample_fn(self, depth: int):
        """``(G or its EMA, z, alpha) -> NHWC images`` at ``depth``, without
        gradients (``pggan_tpu/training/steps.py:339-345``). The training G
        runs without the serve's chain kernel."""
        def sample(G, z, alpha):
            with torch.no_grad():
                return G(z, depth, alpha)
        return sample

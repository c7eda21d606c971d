"""WGAN-GP losses: the counterpart of ``pggan_tpu/losses.py`` (reference
wgan_gp_loss.py).

  D_cost = mean(D(fake) + (-D(real) + D(real)^2 * iwass_epsilon)
                + (||grad_xhat D(xhat)||_2 - target)^2 * lambda / target^2)

with ``xhat = (1 - eps) * real + eps * fake`` and ``eps`` one mixing
factor per sample, drawn by the caller. The gradient penalty (GP) takes
``torch.autograd.grad`` of the summed scores with respect to ``xhat`` with
``create_graph=True``, so that the caller's gradient over D's parameters
differentiates through it a second time: the 3x3 conv, its weight
gradient and the resample pair are autograd Functions whose backward is
built from the kernels again (``ops/conv3x3.py``, ``ops/resample.py``).
Minibatch-stddev couples the samples, so the per-sample input gradients
are those of the summed score, exactly as in the reference. That inner
``autograd.grad`` runs inside ``input_grad_only()``: like JAX's VJP with
respect to ``xhat`` alone, it takes no D weight gradients, which nothing
would use.

``d_fn(x)`` and ``g_fn(z)`` are the critic and the generator at the step's
depth and alpha; ``d_pair_fn(x2)`` scores ``cat([reals, fakes])`` in one
pass with the minibatch-stddev statistic taken per half.
"""

from __future__ import annotations

import torch

from pggan_tpu_torch.ops.conv3x3 import input_grad_only


def calc_gradient_penalty(d_fn, real, fake, mix_eps,
                          iwass_lambda: float = 10.0,
                          iwass_target: float = 1.0) -> torch.Tensor:
    """Per-sample gradient penalty (``pggan_tpu/losses.py:27-44``);
    ``mix_eps`` is (N,)."""
    eps = mix_eps.reshape((-1,) + (1,) * (real.ndim - 1)).to(real.dtype)
    mixed = (real * (1.0 - eps) + fake * eps).detach().requires_grad_(True)
    score = d_fn(mixed).sum()
    with input_grad_only():
        grads, = torch.autograd.grad(score, mixed, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=1) + 1e-12)
    return torch.square(norms - iwass_target) * (iwass_lambda
                                                 / iwass_target ** 2)


def wgan_gp_D_loss(d_fn, g_fn, real, latents, mix_eps,
                   iwass_lambda: float = 10.0, iwass_epsilon: float = 0.001,
                   iwass_target: float = 1.0, d_pair_fn=None):
    """D loss (``pggan_tpu/losses.py:47-80``). Returns ``(cost, (mean
    D_real_loss, mean D_fake_loss))``. The fakes are made under
    ``no_grad``: G is frozen here (the JAX package's ``stop_gradient``),
    and G's graph is never kept."""
    with torch.no_grad():
        fake = g_fn(latents)
    if d_pair_fn is not None and real.shape == fake.shape:
        both = d_pair_fn(torch.cat([real, fake], dim=0))
        d_real, d_fake_loss = both[:real.shape[0]], both[real.shape[0]:]
    else:
        d_real, d_fake_loss = d_fn(real), d_fn(fake)
    d_real_loss = -d_real + torch.square(d_real) * iwass_epsilon
    gp = calc_gradient_penalty(d_fn, real.detach(), fake, mix_eps,
                               iwass_lambda, iwass_target)
    d_cost = torch.mean(d_fake_loss.reshape(-1) + d_real_loss.reshape(-1) + gp)
    return d_cost, (torch.mean(d_real_loss), torch.mean(d_fake_loss))


def wgan_gp_G_loss(g_fn, d_fn, latents) -> torch.Tensor:
    """G loss ``mean(-D(G(z)))`` (``pggan_tpu/losses.py:83-86``)."""
    return torch.mean(-d_fn(g_fn(latents)))

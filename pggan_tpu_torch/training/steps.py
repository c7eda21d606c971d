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

Each graph draws its noise from a generator of its own, registered with
it, that takes the state's generator state before a replay and gives it
back after: the same draws as from the state's generator, and no capture
ever marks the state's generator as being captured, so a capture can run
on one thread while another replays and draws. Captures record in the
``thread_local`` mode: the calls that the global mode forbids every
thread during a capture (an event query, a pinned allocation, NCCL's
watchdog) stay legal on the other threads. The builder's lock keeps the
runs of its raw steps (eager calls, warm-ups, captures) one at a time: a
step's gradient penalty sets the conv Functions' process-wide
``input_grad_only`` flag (``ops/conv3x3.py``), which a step on another
thread would read, and the two would leave it set. A replay runs no Python
and takes no lock.

``precompile`` is the JAX package's ahead-of-time compile of a step
(``pggan_tpu/training/steps.py:275-298``): for one key it runs the key's
eager step once on a scratch copy of the state (``state.scratch_copy``),
on a side stream on the card (the warm-up: cuDNN's plans, the allocator,
the kernel library), and then, on the card with ``cuda_graphs``, binds
the key's graph to the real state and captures it into the builder's
pool. A capture records and runs nothing, so the real state is not
touched; the key's first call then replays. A group's warm-up is one
step of its key (the same kernels at the same shapes). ``precompile_ahead``
queues a list of them, on one scratch copy taken at the call, for the
builder's precompile thread (one long-lived worker, ``pggan-precompile``,
that runs them in order); each key's first dispatch waits for its
precompile (``await_precompile``) and raises its failure there. Under a
process group the warm-up takes this rank's batch alone, without a
collective (its numbers are thrown away; its kernels and shapes are the
step's), so the precompile thread never calls the process group, and the
capture waits for the key's first dispatch on the training thread: all
ranks reach it at the same point. PyTorch keeps cuDNN's plan picks per
thread, and passes over a plan whose workspace does not fit in the free
memory: near the card's memory limit the precompile thread's graphs may
run other (deterministic) plans than the training thread's, and the two
routes then differ in rounding.

``group_step_fn`` is the JAX package's grouped dispatch
(``steps.py:202-273``): ``group`` consecutive steps as one program. Step
k reads the k-th batch of the reals and the k-th entries of the alpha and
learning-rate vectors, so a fade and the lr ramp advance inside the group
as they would across separate steps, and the metrics come back stacked,
one per step. On the card the K steps are recorded in order into one CUDA
graph, under the same rules as a step's graph (eager first call, capture
at the second, the state's generator registered, the builder's pool):
one launch from Python for K steps. On the CPU, and without
``cuda_graphs``, it runs the K steps in a loop.

Random draws come in the JAX step's order: per D repeat the latents and
then the GP mixing factors, then G's latents (``steps.py:129-131,152-153``,
``losses.py:74``). They come from a ``noise(kind, shape)`` hook, ``kind``
``"normal"`` or ``"uniform"``; by default it draws from the state's device
``torch.Generator``. Tests pass in the JAX step's own draws. A StyleGAN G
(``models/style.py``, a G with ``draw``) draws more after each of its
latents z, before anything else: the second latents z2 (normal, (B,
latent)), the mixing coin (uniform, ()), the cutoff (uniform, ()), then
one noise image a synthesis layer from layer 0 up (normal, (B, 1, res,
res)); so a D repeat draws z, G's draws, then the mixing factors, and the
G half z, then G's draws. Both of G's forwards are training forwards:
each updates G's ``w_avg`` and mixes styles.

TF32 is switched off when the builder is made: cuDNN's convolutions (the
low-resolution stages) default to it on the card.

With a process group (``group``, a ``parallel.Group``) the step is one
rank's share of a data-parallel step (``pggan_tpu/training/steps.py:64-71,
110-119`` under a mesh): it takes this rank's local batch; D takes its
minibatch-stddev statistic over the global batch; the merged real+fake D
pass is off, as under the JAX mesh; each model's gradients are averaged
over the ranks in one flat all-reduce per D repeat and one for G before
Adam; the four metrics are all-reduced to their global means. Under NCCL the step is graphed as above: its eager first
call creates the communicator, and the capture records the collectives.
Gloo cannot be captured, so a gloo group on the card takes the eager route
(``cuda_graphs=False``; ``True`` raises).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import threading
import time

import numpy as np
import torch

from pggan_tpu_torch.losses import wgan_gp_D_loss, wgan_gp_G_loss
from pggan_tpu_torch.ops import _build
from pggan_tpu_torch.ops.primitives import f32_scalar, f32_vector
from pggan_tpu_torch.parallel import all_reduce_grads, global_mean
from pggan_tpu_torch.sampling import disable_tf32
from pggan_tpu_torch.training.state import TrainState, scratch_copy


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
    return _generator_noise(state.generator)


def _generator_noise(gen: torch.Generator):
    """Draws from ``gen``."""
    def noise(kind: str, shape) -> torch.Tensor:
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=gen.device)
        if kind == "uniform":
            return torch.rand(shape, generator=gen, device=gen.device)
        raise ValueError(f"unknown noise kind {kind!r}")
    return noise


def _set(static: torch.Tensor, value) -> None:
    """Write a step input into its static tensor: a tensor by a copy, a
    number by a fill on the device, a host vector by a copy from pinned
    memory."""
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    elif np.ndim(value):
        static.copy_(f32_vector(value, static.device))
    else:
        static.fill_(float(value))


class _GraphedStep:
    """One (depth, batch, fade) step, or ``n_steps`` of them as a group, on
    the card: eager on its first call, captured into a CUDA graph and
    replayed on its second, replayed after; or, once ``precompile`` has
    warmed it up and captured it ahead, replayed from its first call.
    Alpha and the learning rates are numbers for a step and (n_steps,)
    vectors for a group. The graph is bound to the state of the first call
    (or of the precompile) and returns the same static metric tensors at
    every replay, which the next replay overwrites: clone what must
    outlive it."""

    def __init__(self, raw, builder, n_steps=None):
        self.raw, self.builder, self.n_steps = raw, builder, n_steps
        self.state = None
        self.warm = False  # an eager call (or a precompile's warm-up) ran
        self.ahead = False  # warmed up (and captured) by a precompile
        self.graph = None
        self.out = None  # the graph's static metrics
        self.eager_s = None  # host seconds of an eager first call here
        self.warm_s = None  # host seconds of the precompile's warm-up
        self.capture_s = None  # host seconds of the capture
        self.captured = None  # kernel wrapper calls recorded, by kernel
        self.replays = 0

    def _bind(self, state, shape, device) -> None:
        """Bind to ``state``: the static reals of ``shape``, the static
        scalars and the graph's own generator."""
        if self.state is None:
            self.state = state
            self.reals = torch.empty(shape, device=device)
            size = (3,) if self.n_steps is None else (3, self.n_steps)
            self.scalars = torch.zeros(size, dtype=torch.float32,
                                       device=device)
            self.gen = torch.Generator(device=device)
        elif state is not self.state:
            raise ValueError("this graphed step is bound to the state of its "
                             "first call")
        if tuple(shape) != tuple(self.reals.shape):
            raise ValueError(f"reals {tuple(shape)}, expected "
                             f"{tuple(self.reals.shape)}")

    def __call__(self, state, reals, alpha, lr_d, lr_g, noise=None):
        if reals.device.type != "cuda":
            return self.raw(state, reals, alpha, lr_d, lr_g, noise)
        if noise is not None:
            raise ValueError("a graphed step draws from the state's "
                             "generator; pass noise to the eager route "
                             "(TrainStepBuilder(..., cuda_graphs=False))")
        self._bind(state, reals.shape, reals.device)
        self.reals.copy_(reals)
        for static, value in zip(self.scalars, (alpha, lr_d, lr_g)):
            _set(static, value)
        args = (state, self.reals, *self.scalars)
        if self.graph is None:
            if not self.warm:
                self.warm = True  # the first call: a real, eager step
                t0 = time.perf_counter()
                out = self.raw(*args)
                self.eager_s = time.perf_counter() - t0
                return out
            self._capture(args)
        self.gen.set_state(state.generator.get_state())
        self.graph.replay()
        state.generator.set_state(self.gen.get_state())
        self.replays += 1
        return self.out

    def _capture(self, args) -> None:
        """Record the step on ``args`` into a graph in the builder's pool,
        on the builder's capture stream, ordered after the work queued on
        the current stream; the current stream then waits for the
        capture's own set-up (its generators' seed and offset fills)."""
        device = args[1].device
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        stream = self.builder.stream("capture", device)
        current = torch.cuda.current_stream(device)
        with self.builder.lock:
            stream.wait_stream(current)
            before = collections.Counter(_build.CAPTURED)
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.builder.graph_pool(),
                                    capture_error_mode="thread_local")
                try:
                    self.out = self.raw(*args, _generator_noise(self.gen))
                finally:
                    graph.capture_end()
            stream.synchronize()
            self.capture_s = time.perf_counter() - t0
            self.captured = _build.CAPTURED - before
            current.wait_stream(stream)
            self.graph = graph


class TrainStepBuilder:
    """Train steps for (depth, batch_size, fade), the input prep and the
    sampling function; ``group`` makes each step one rank's share of a
    data-parallel step (see the module docstring)."""

    def __init__(self, G, D, d_training_repeats: int = 1,
                 iwass_lambda: float = 10.0, iwass_epsilon: float = 0.001,
                 iwass_target: float = 1.0, g_ema_beta: float | None = None,
                 cuda_graphs: bool = True, group=None):
        if G.inference_chain:
            raise ValueError("train with inference_chain=False: the chain "
                             "kernel is forward-only")
        if (group is not None and cuda_graphs and group.device.type == "cuda"
                and group.backend == "gloo"):
            raise ValueError("gloo's collectives cannot be captured into a "
                             "CUDA graph: a gloo group on the card trains "
                             "eagerly (cuda_graphs=False), or use nccl")
        self.G, self.D = G, D
        self.d_training_repeats = int(d_training_repeats)
        self.iwass_lambda = float(iwass_lambda)
        self.iwass_epsilon = float(iwass_epsilon)
        self.iwass_target = float(iwass_target)
        self.g_ema_beta = (None if g_ema_beta is None or g_ema_beta <= 0
                           else float(g_ema_beta))
        self.cuda_graphs = bool(cuda_graphs)
        self.group = group
        D.group = group
        self._steps: dict = {}
        self._pool = None
        self._streams: dict = {}
        # raw steps and captures, one at a time (module docstring)
        self.lock = threading.RLock()
        self._precompiles: dict = {}  # key -> Future, until its 1st dispatch
        self._worker = None  # the precompile thread's executor
        # kernel wrappers launched by the warm-ups on the card
        self.precompile_launches: collections.Counter = collections.Counter()
        disable_tf32()

    def graph_pool(self):
        """The memory pool that every graph of this builder shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self, role: str, device) -> torch.cuda.Stream:
        """The builder's side stream for ``role`` (``"capture"`` or
        ``"warm"``) on ``device``; launches on the warm-up stream count in
        ``precompile_launches``."""
        key = (role, device)
        if key not in self._streams:
            self._streams[key] = torch.cuda.Stream(device)
            if role == "warm":
                _build.STREAM_COUNTS[self._streams[key].cuda_stream] = \
                    self.precompile_launches
        return self._streams[key]

    def graphs(self) -> dict:
        """The captured graphs by key: (depth, batch, fade) for a step,
        (depth, batch, fade, group) for a group."""
        return {k: s for k, s in sorted(self._steps.items())
                if getattr(s, "graph", None) is not None}

    def step_fn(self, depth: int, batch_size: int, fade: bool = True):
        """``step(state, reals, alpha, lr_d, lr_g, noise=None) -> metrics``:
        reals (R, B, H, W, C) f32 on the device (under a group B is this
        rank's local batch, and ``batch_size`` too); alpha and the learning
        rates numbers or 0-d float32 device tensors; the metrics are the
        device scalars ``G_loss``, ``D_loss``, ``D_real``, ``D_fake`` of the
        last D repeat (``steps.py:177-184``; global means under a group).
        Updates ``state`` in place.
        With ``cuda_graphs`` a CUDA state's step is graphed (see the module
        docstring): its metrics are overwritten by its next call."""
        key = (depth, batch_size, fade)
        if key not in self._steps:
            raw = self._raw_step(depth, batch_size, fade)
            self._steps[key] = (_GraphedStep(raw, self) if self.cuda_graphs
                                else raw)
        return self._steps[key]

    def group_step_fn(self, depth: int, batch_size: int, fade: bool,
                      group: int):
        """``gstep(state, reals, alphas, lrs_d, lrs_g, noise=None) ->
        metrics``: ``group`` steps of ``step_fn(depth, batch_size, fade)``
        in order (``pggan_tpu/training/steps.py:263-273``). reals (group, R,
        B, H, W, C) f32 on the device; alphas and the learning rates
        (group,) vectors, host arrays or float32 device tensors; the four
        metrics (group,) device tensors, step k's at k. With
        ``cuda_graphs`` a CUDA state's group is one graph (see the module
        docstring)."""
        key = (depth, batch_size, fade, group)
        if key not in self._steps:
            raw = self._raw_group(self._raw_step(depth, batch_size, fade),
                                  group)
            self._steps[key] = (_GraphedStep(raw, self, group)
                                if self.cuda_graphs else raw)
        return self._steps[key]

    def precompile(self, depth: int, batch_size: int, fade: bool, state,
                   group: int | None = None, scratch=None) -> None:
        """Make the step of (depth, batch_size, fade), or with ``group`` the
        ``group_step_fn`` of that many steps, ready before its first call
        (``pggan_tpu/training/steps.py:275-298``): create it as
        ``step_fn`` / ``group_step_fn`` would, run one eager step of the
        key on ``scratch`` (a ``scratch_copy`` of ``state`` made here when
        None; on the card on the builder's warm-up stream), then, for a
        graphed step on the card, bind it to ``state`` and capture it
        (without a process group; under one the capture waits for the
        first call, see the module docstring). ``state`` is never written.
        The step's ``warm_s`` and ``capture_s`` hold the seconds. Raises on
        a failure."""
        step = (self.step_fn(depth, batch_size, fade) if group is None else
                self.group_step_fn(depth, batch_size, fade, group))
        if getattr(step, "warm", False):
            return  # called already: warm, or captured
        if scratch is None:
            scratch = scratch_copy(state)
        device = scratch.generator.device
        shape = self.real_batch_shape(depth, batch_size)
        raw = self._raw_step(depth, batch_size, fade, local=True)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as on_side:
            if device.type == "cuda":
                warm = self.stream("warm", device)
                warm.wait_stream(torch.cuda.current_stream(device))
                on_side.enter_context(torch.cuda.stream(warm))
            # the inputs' types as the graphed step passes them: alpha and
            # the learning rates as 0-d device tensors (lr 0)
            raw(scratch, torch.zeros(shape, device=device),
                *torch.tensor([1.0, 0.0, 0.0], device=device))
            if device.type == "cuda":
                warm.synchronize()
        warm_s = time.perf_counter() - t0
        if not isinstance(step, _GraphedStep) or device.type != "cuda":
            return
        step.warm_s = warm_s
        lead = () if group is None else (group,)
        step._bind(state, lead + shape, device)
        step.warm = step.ahead = True
        if self.group is None:
            step._capture((state, step.reals, *step.scalars))

    def precompile_ahead(self, targets, state) -> None:
        """Queue ``precompile`` of each of ``targets`` ((depth, batch_size,
        fade, group) tuples, group None for a single step) for the
        builder's precompile thread, all on one scratch copy of ``state``
        taken now. Until one is done, its key's first dispatch waits for it
        (``await_precompile``), which raises its failure; nothing falls
        back. Targets whose step exists, or is queued, already are
        skipped."""
        jobs = []
        for depth, batch_size, fade, group in targets:
            key = (depth, batch_size, fade) + (() if group is None
                                              else (group,))
            if key not in self._steps and key not in self._precompiles:
                jobs.append((key, (depth, batch_size, fade, state, group)))
        if not jobs:
            return
        scratch = scratch_copy(state)
        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="pggan-precompile")
        for key, args in jobs:
            self._precompiles[key] = self._worker.submit(
                self.precompile, *args, scratch=scratch)

    def join_precompiles(self, cancel: bool = False) -> None:
        """Wait for the queued precompiles, and end the precompile thread
        (a later ``precompile_ahead`` starts another). ``cancel`` drops
        those not started yet: their keys take the route of a key never
        precompiled."""
        if self._worker is not None:
            self._worker.shutdown(wait=True, cancel_futures=cancel)
            self._worker = None
            self._precompiles = {k: f for k, f in self._precompiles.items()
                                 if not f.cancelled()}

    def await_precompile(self, key) -> None:
        """Before the dispatch at ``key``: wait for a precompile of it that
        has not finished, and raise its failure."""
        job = self._precompiles.pop(key, None)
        if job is None:
            return
        error = job.exception()
        if error is not None:
            raise RuntimeError(f"the precompile of step {key} failed: "
                               f"{error!r}") from error

    @staticmethod
    def _raw_group(step, group: int):
        """The eager group that ``group_step_fn`` runs or captures."""
        def gstep(state, reals, alphas, lrs_d, lrs_g, noise=None):
            if reals.shape[0] != group:
                raise ValueError(f"reals {tuple(reals.shape)}, expected "
                                 f"({group}, ...)")
            steps = [step(state, reals[k], alphas[k], lrs_d[k], lrs_g[k],
                          noise) for k in range(group)]
            return {name: torch.stack([m[name] for m in steps])
                    for name in steps[0]}
        return gstep

    def _raw_step(self, depth: int, batch_size: int, fade: bool,
                  local: bool = False):
        """The eager step that ``step_fn`` runs or captures; ``local``: of
        this rank's batch alone, without a collective (the precompile's
        warm-up, on a state whose D has no group)."""
        lam, drift, target = (self.iwass_lambda, self.iwass_epsilon,
                              self.iwass_target)
        repeats, beta = self.d_training_repeats, self.g_ema_beta
        group = None if local else self.group
        pair = self.group is None  # a pair pass has a per-rank statistic
        lock = self.lock

        def step(*args, **kwargs):
            with lock:  # one raw step at a time (module docstring)
                return body(*args, **kwargs)

        def body(state: TrainState, reals, alpha, lr_d, lr_g, noise=None):
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

            if not pair:
                d_pair_fn = None

            def latents():
                """z, and a StyleGAN G's draws (module docstring)."""
                z = noise("normal", latent)
                extra = (G.draw(noise, batch_size, depth)
                         if hasattr(G, "draw") else None)
                return z, extra

            def g_fn_of(extra):
                if extra is None:
                    return lambda z: G(z, depth, alpha, fade)
                return lambda z: G(z, depth, alpha, fade, draws=extra)

            d_params = list(D.parameters())
            for r in range(repeats):
                z, extra = latents()
                mix = noise("uniform", (batch_size,))
                d_cost, (d_real, d_fake) = wgan_gp_D_loss(
                    d_fn, g_fn_of(extra), reals[r], z, mix, lam, drift,
                    target, d_pair_fn=d_pair_fn)
                grads = _grads(d_cost, d_params)
                if group is not None:
                    grads = all_reduce_grads(grads, group)
                state.d_opt.step(grads, lr_d)

            z, extra = latents()
            g_fn = g_fn_of(extra)
            with _frozen(D):
                g_cost = wgan_gp_G_loss(g_fn, d_fn, z)
                g_params = list(G.parameters())
                g_grads = _grads(g_cost, g_params)
            if group is not None:
                g_grads = all_reduce_grads(g_grads, group)
            state.g_opt.step(g_grads, lr_g)

            if beta is not None:
                with torch.no_grad():
                    torch._foreach_lerp_(list(state.g_ema.parameters()),
                                         g_params, 1.0 - beta)
                    # buffers (StyleGAN's w_avg) are copied, as
                    # StyleGAN's Gs takes G's non-trainables
                    for ema_b, b in zip(state.g_ema.buffers(), G.buffers()):
                        ema_b.copy_(b)
            metrics = {"G_loss": g_cost.detach(), "D_loss": d_cost.detach(),
                       "D_real": d_real.detach(), "D_fake": d_fake.detach()}
            if group is not None:  # one all-reduce of the four
                means = global_mean(torch.stack(list(metrics.values())),
                                    group)
                metrics = dict(zip(metrics, means.unbind()))
            return metrics

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
                     else f32_vector(alpha, x.device))
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

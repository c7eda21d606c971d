"""Data parallelism over ``torch.distributed``: the counterpart of
``pggan_tpu/parallel/mesh.py``.

The JAX package shards the batch over a 1-D device mesh and lets GSPMD
insert the collectives. Here each device is one process (launched with
``torchrun --nproc_per_node N``), and the collectives are explicit:

- the batch is split into equal per-rank shards (``shard_batch``; the
  loader draws each rank's shard from its own slice of the items);
- parameters, buffers and Adam state are replicated: broadcast from rank 0
  at start and on resume (``replicate``), after which every rank takes the
  same updates;
- each rank's loss is the mean over its shard; the gradients of each model
  are averaged over the ranks in one flat buffer before Adam
  (``all_reduce_grads``), which with equal shards is the gradient of the
  global-batch loss;
- minibatch stddev, the one operation that couples samples, takes its
  statistic over the global batch through ``all_reduce_sum``, whose
  backward is again an all-reduce: twice differentiable, as the gradient
  penalty needs.

``DistributedDataParallel`` is not used: its reducer hooks ``.grad``
accumulation, which the step's ``torch.autograd.grad`` bypasses, and it
does not support the gradient penalty's double backward.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel process group (the
    default ``torch.distributed`` group): its rank, the world size and the
    device it computes on."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @classmethod
    def current(cls, device) -> "Group":
        """The handle of the initialised process group, for ``device``."""
        return cls(dist.get_rank(), dist.get_world_size(),
                   torch.device(device))


def initialize_distributed(device_type: str = "cuda",
                           backend: str | None = None) -> Group | None:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    / ``MASTER_PORT``) and return this rank's handle; None when that
    environment is absent (a single-process run). Each rank computes on
    ``cuda:LOCAL_RANK`` (made current) for ``device_type`` ``"cuda"``, on
    the CPU for ``"cpu"``. ``backend`` defaults to ``nccl`` on the card
    and ``gloo`` on the CPU. A process group the caller already
    initialised (a ``FileStore``, say) is adopted as it is."""
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"no data parallelism on {device_type!r}")
    if dist.is_initialized():
        return Group.current(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return Group.current(device)


@torch.no_grad()
def replicate(tensors) -> None:
    """Broadcast ``tensors`` (parameters, buffers, optimizer state) from
    rank 0, in place."""
    for t in tensors:
        dist.broadcast(t, src=0)


def shard_batch(array, group: Group, batch_dim: int = 0):
    """This rank's equal slice of a global array along ``batch_dim``."""
    n = array.shape[batch_dim]
    check_batch_divisible(n, group.world_size)
    per = n // group.world_size
    index = [slice(None)] * array.ndim
    index[batch_dim] = slice(group.rank * per, (group.rank + 1) * per)
    return array[tuple(index)]


def fit_minibatch_to_mesh(minibatch_default: int, minibatch_overrides,
                          world_size: int):
    """The per-depth global-batch policy over ``world_size`` ranks
    (``pggan_tpu/parallel/mesh.py:105-135``): each global batch rounded UP
    to a multiple of the world size, never below the reference batch.
    Returns ``(default', overrides', changed)``, ``changed`` mapping the
    depth (-1 for the default) to ``(old, new)``."""
    n = int(world_size)

    def up(b):
        return ((int(b) + n - 1) // n) * n

    overrides = dict(minibatch_overrides or {})
    new_default = up(minibatch_default)
    new_overrides = {d: up(b) for d, b in overrides.items()}
    changed = {d: (overrides[d], b) for d, b in new_overrides.items()
               if b != overrides[d]}
    if new_default != minibatch_default:
        changed[-1] = (minibatch_default, new_default)
    return new_default, new_overrides, changed


def check_batch_divisible(batch_size: int, world_size: int,
                          axis_name: str = "data") -> None:
    n = int(world_size)
    if batch_size % n != 0:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the {axis_name} "
            f"axis size {n}; override the per-depth minibatch "
            f"(--DepthManager.minibatch_default / .minibatch_overrides) to a "
            f"multiple of the device count")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the upstream gradients over
    the ranks, through this Function again, so it differentiates twice
    (what ``torch.distributed.nn.functional.all_reduce`` computes, without
    its deprecation warning at every call)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable to any order."""
    return _AllReduceSum.apply(x)


def global_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of ``x`` over the ranks (equal shards: the global mean of
    per-rank means), differentiable."""
    return all_reduce_sum(x) / group.world_size


def all_reduce_grads(grads, group: Group) -> list:
    """The mean of each gradient over the ranks, in one flat buffer (one
    all-reduce), as views of the buffer shaped as ``grads``. NCCL averages
    in the collective (``AVG``: each rank's share scaled by 1 / world size,
    then summed); gloo has no ``AVG``: a sum, then a division."""
    grads = list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    if group.backend == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
    else:
        dist.all_reduce(flat)
        flat.div_(group.world_size)
    return [v.view_as(g) for v, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def gather_generator_states(generator: torch.Generator,
                            group: Group) -> list:
    """Every rank's ``generator`` state, in rank order, on every rank (a
    collective: each rank calls it)."""
    state = generator.get_state().to(group.device)
    out = [torch.empty_like(state) for _ in range(group.world_size)]
    dist.all_gather(out, state)
    return [s.cpu() for s in out]

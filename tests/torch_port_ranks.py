"""One rank of a data-parallel case of ``test_torch_port_parallel.py``.

    python tests/torch_port_ranks.py CASE WORKDIR RANK WORLD

Joins a gloo process group over a ``FileStore`` in WORKDIR, reads the
case's inputs from ``WORKDIR/in.pkl``, runs the case on the CPU and writes
this rank's results to ``WORKDIR/out{RANK}.pkl``. It imports torch and the
port, never JAX, so that a rank starts in seconds.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch
import torch.distributed as dist

from pggan_tpu_torch import checkpoint
from pggan_tpu_torch.parallel import Group, shard_batch


def _stddev(inp, group):
    """The global minibatch stddev of this rank's shard: its value, the
    gradient of ``sum(c * out)`` and that gradient's gradient along v."""
    from pggan_tpu_torch.ops.primitives import minibatch_stddev
    x, c, v = (shard_batch(torch.from_numpy(inp[k]), group)
               for k in ("x", "c", "v"))
    x.requires_grad_(True)
    out = minibatch_stddev(x, group=group)
    g, = torch.autograd.grad((out * c).sum(), x, create_graph=True)
    h, = torch.autograd.grad((g * v).sum(), x)
    return {"out": out.detach().numpy(), "g": g.detach().numpy(),
            "h": h.numpy()}


def _replay(draws, group):
    """The noise hook: this rank's slice of each of the global draws."""
    it = iter(draws)

    def noise(kind, shape):
        want_kind, value = next(it)
        local = shard_batch(torch.from_numpy(value), group)
        assert (kind, tuple(shape)) == (want_kind, tuple(local.shape))
        return local
    return noise


def _step(inp, group):
    """Steps of the port's data-parallel builder on this rank's shards."""
    from pggan_tpu_torch.models import Discriminator, Generator
    from pggan_tpu_torch.training import TrainStepBuilder, init_state
    G = Generator(inp["shape"], **inp["g_kw"])
    D = Discriminator(inp["shape"], **inp["d_kw"])
    if group.rank == 0:  # the other ranks get these by replication
        G.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inp["g_sd"].items()})
        D.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inp["d_sd"].items()})
    builder = TrainStepBuilder(G, D, d_training_repeats=inp["repeats"],
                               group=group)
    state = init_state(G, D, group=group)
    noise = _replay(inp["draws"], group)
    metrics = []
    for fade, reals in zip(inp["fades"], inp["reals"]):
        local = shard_batch(torch.from_numpy(reals), group, batch_dim=1)
        step = builder.step_fn(inp["depth"], local.shape[1], fade)
        m = step(state, local, 0.5 if fade else 1.0, inp["lr"], inp["lr"],
                 noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "state": checkpoint.training_state_dict(state),
            "no_grad": all(p.grad is None for p in
                           [*G.parameters(), *D.parameters()])}


def _cli(inp, group):
    """Three train CLI runs on every rank: to T, to T/2, and a resume of
    the second to T."""
    from pggan_tpu_torch.cli import train as cli
    out = {}
    for name, argv in inp["runs"]:
        trainer = cli.cli_main(argv)
        out[name] = {"state": checkpoint.training_state_dict(trainer.state),
                     "cur_nimg": trainer.cur_nimg,
                     "iterations": trainer.iterations,
                     "minibatch_size": trainer.minibatch_size,
                     "dataiter_batch": trainer.dataiter.batch_size}
    return out


def _precompile(inp, group):
    """Train CLI runs on every rank, with and without
    ``--DepthManager.precompile_ahead``: the state, the clock, the
    collectives called (from the training thread, and from any other),
    and the keys made ready ahead."""
    import threading
    from pggan_tpu_torch.cli import train as cli
    out = {}
    calls = []
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}

    def spy(name):
        def call(*args, **kwargs):
            calls.append(threading.current_thread() is threading.main_thread())
            return real[name](*args, **kwargs)
        return call
    for name in real:
        setattr(dist, name, spy(name))
    try:
        for name, argv in inp["runs"]:
            calls.clear()
            trainer = cli.cli_main(argv)  # its precompile thread joined
            out[name] = {
                "state": checkpoint.training_state_dict(trainer.state),
                "iterations": trainer.iterations,
                "collectives": calls.count(True),
                "collectives_off_the_training_thread": calls.count(False),
                "precompiled": set(trainer.builder._steps)}
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    return out


CASES = {"stddev": _stddev, "step": _step, "cli": _cli,
         "precompile": _precompile}


def main(case, workdir, rank, world):
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, "in.pkl"), "rb") as f:
            inp = pickle.load(f)
        out = CASES[case](inp, Group.current("cpu"))
        with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))

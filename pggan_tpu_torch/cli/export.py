"""Export a generator snapshot to a ``torch.export`` serving artifact (the
counterpart of ``pggan_tpu/cli/export.py``): a self-contained program,
weights included, that runs under PyTorch without this package:

    python -m pggan_tpu_torch.cli.export \\
        --generator_path latest --batch 16 \\
        --out exported/generator --verify True

The flags are those of ``pggan_tpu/cli/export.py`` plus ``--device``
(default ``cuda``, where the snapshot is loaded and traced; without a card
it raises, as the port's other CLIs do). ``--platforms`` takes at most one
of ``['cpu']`` / ``['cuda']``; ``[]`` is the device's. ``--batch -1``
exports a polymorphic batch. Consume an artifact from a bare environment::

    import torch
    program = torch.export.load("generator.pt2")
    images = program.module()(latents)   # (batch, latent) -> (batch,H,W,C)
"""

from __future__ import annotations

from argparse import ArgumentParser
from functools import partial

import numpy as np
import torch

from pggan_tpu_torch.checkpoint import load_snapshot, resolve_generator_path
from pggan_tpu_torch.cli.generate import resolve_device
from pggan_tpu_torch.export import (
    export_generator,
    exportable,
    load_exported,
    program_platform,
    save_exported,
)
from pggan_tpu_torch.sampling import disable_tf32
from pggan_tpu_torch.utils.config import generic_arg_parse

default_params = {
    "generator_path": "",    # a snapshot path, or 'latest' (see result_dir)
    "result_dir": "results",
    "out": "exported/generator",
    "batch": 16,             # frozen serving batch; <=0 = polymorphic 'b'
    "platforms": [],         # ['cpu'] or ['cuda']; [] = the device's
    "verify": True,          # round-trip: load, run, compare
    "device": "cuda",
}


def export_main(generator_path, out, batch, platforms=(), verify=True,
                result_dir="results", device="cuda"):
    device = resolve_device(device)
    disable_tf32()
    generator_path = resolve_generator_path(generator_path, result_dir)
    print(f"Loading {generator_path}")
    G, meta = load_snapshot(generator_path, device=device)
    depth, alpha = meta["depth"], meta["alpha"]
    res = 4 * 2 ** depth
    poly = int(batch) <= 0
    print(f"Exporting depth {depth} ({res}x{res}), alpha {alpha}, "
          f"batch {'polymorphic (b)' if poly else batch}, "
          f"platforms {list(platforms) or [device.type]}")
    program = export_generator(G, depth, alpha, batch,
                               platforms=list(platforms) or None)
    artifact, sidecar = save_exported(program, out, {
        "source_snapshot": generator_path,
        "depth": int(depth),
        "alpha": float(alpha),
        "resolution": res,
        "batch": "polymorphic" if poly else int(batch),
        "latent_size": int(G.latent_size),
        "compute_dtype": str(G.compute_dtype),
    })
    print(f"Wrote {artifact} + {sidecar}")
    if verify:
        verify_artifact(artifact, G, depth, alpha, [4, 7] if poly
                        else [int(batch)])
    return artifact


def verify_artifact(artifact, G, depth, alpha, batches) -> float:
    """The loaded artifact against a direct forward of the program it was
    traced from (``exportable``'s tail-off G with ``kernels=False``) on the
    artifact's platform, at each batch size, within atol 1e-5; returns the
    largest difference. Both run with cuDNN held to its deterministic
    algorithms: its default ones for G's transposed convs may sum with
    atomics, so two runs of one program need not agree bit for bit. (With
    the kernels, the NCHW stages' convs would run ``ops/wide_conv.py``'s
    kernel pair, whose sums differ from cuDNN's in the last bits.)"""
    program = load_exported(artifact)
    platform = program_platform(program)
    run = program.module()
    direct = exportable(G).to(platform)
    alpha = float(np.float32(alpha))
    worst = 0.0
    deterministic = torch.backends.cudnn.deterministic
    for n in batches:
        z = torch.from_numpy(np.random.RandomState(n).randn(
            n, G.latent_size).astype(np.float32)).to(platform)
        torch.backends.cudnn.deterministic = True
        try:
            with torch.no_grad():
                got = run(z)
                want = direct(z, depth, alpha, alpha < 1.0, kernels=False)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if got.shape != want.shape or not torch.allclose(got, want, rtol=0,
                                                         atol=1e-5):
            raise SystemExit(f"verify FAILED at batch {n}: shape "
                             f"{tuple(got.shape)}, max|diff|={err:.3e}")
        print(f"Verify: batch {n} on {platform}: the artifact matches the "
              f"direct forward (max|diff|={err:.3e})")
    return worst


def cli_main(argv=None):
    parser = ArgumentParser(description=__doc__)
    for k in default_params:
        parser.add_argument(
            f"--{k}",
            type=partial(generic_arg_parse, hinttype=type(default_params[k])))
    parser.set_defaults(**default_params)
    args = vars(parser.parse_args(argv))
    if not args["generator_path"]:
        raise SystemExit("--generator_path is required (a path or 'latest')")
    return export_main(args["generator_path"], args["out"], args["batch"],
                       args["platforms"], args["verify"], args["result_dir"],
                       args["device"])


if __name__ == "__main__":
    cli_main()

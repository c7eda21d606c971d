"""Serving entry point: load a generator snapshot, draw latents, run the
forward at the snapshot's (depth, alpha) on one device, and pipe the NCHW
numpy output through the configured postprocessors:

    python -m pggan_tpu_torch.cli.generate \\
        --generator_path results/001-exp/network-snapshot-generator-003000.dat \\
        --num_samples 6 --postprocessors "['ImageSaver']"

The flags are those of ``pggan_tpu/cli/generate.py`` plus ``--device``
(default ``cuda``), which never falls back to the CPU: without a card the
default raises. ``--device`` also sets a postprocessor's ``device`` (the
SoundSaver's Griffin-Lim) unless ``--SoundSaver.device`` is given.
Snapshots from either package load, and the port's StyleGAN snapshots;
``--truncation_psi`` sets a StyleGAN generator's truncation (0.7 on
layers 0-7 by default, the snapshot's own; 1 turns it off).
"""

from __future__ import annotations

from argparse import ArgumentParser
from functools import partial

import numpy as np
import torch

import pggan_tpu_torch.postprocess as postprocess_module
from pggan_tpu_torch.checkpoint import load_snapshot, resolve_generator_path
from pggan_tpu_torch.sampling import sample_images
from pggan_tpu_torch.utils.config import (
    add_class_args,
    generic_arg_parse,
    get_all_classes,
    get_structured_params,
    pass_device,
)

default_params = {
    "generator_path": "",   # a snapshot path, or 'latest' (see result_dir)
    "result_dir": "results",  # search root for --generator_path latest
    "num_samples": 6,
    "minibatch": 0,  # 0 = one forward; k = serve fixed padded chunks of k
    "postprocessors": [],
    "description": "unknown",
    "random_seed": 0,
    "inference_chain": True,  # fused conv-pair kernel in the tail
    "device": "cuda",
}
# the port's flags beyond the JAX CLI's (whose defaults default_params
# keeps)
port_params = {
    "truncation_psi": -1.0,  # StyleGAN only; < 0: the snapshot's own (0.7)
}


def resolve_device(name: str) -> torch.device:
    """The serving device. ``cuda`` without a card raises; there is no
    fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available (pass "
                           "--device cpu to serve on the CPU explicitly)")
    return device


def output_samples(generator_path, num_samples, postprocessors, description,
                   random_seed=0, result_dir="results", minibatch=0,
                   inference_chain=True, device="cuda", truncation_psi=None):
    device = resolve_device(device)
    generator_path = resolve_generator_path(generator_path, result_dir)
    print(f"Loading {generator_path}")
    G, meta = load_snapshot(generator_path, device=device)
    if truncation_psi is not None and truncation_psi < 0:
        truncation_psi = None
    if inference_chain:
        G.inference_chain = True  # serving-only fused conv pairs
    print(f"Generating ({device}, minibatch {minibatch or num_samples})...")
    rng = np.random.RandomState(random_seed)
    out = sample_images(G, meta["depth"], meta["alpha"], num_samples,
                        minibatch=minibatch, rng=rng,
                        truncation_psi=truncation_psi)
    out = out.transpose(0, 3, 1, 2)  # -> NCHW for the postprocessors
    print("Done.")
    for proc in postprocessors:
        print(f"Outputting for postprocessor: {proc}")
        proc(out, description)
    print("Done.")
    return out


def cli_main(argv=None):
    parser = ArgumentParser(description=__doc__)
    flat_defaults = {**default_params, **port_params}
    for k, v in flat_defaults.items():
        parser.add_argument(
            f"--{k}", type=partial(generic_arg_parse, hinttype=type(v)))
    add_class_args(parser, get_all_classes(postprocess_module),
                   default_params=flat_defaults)
    parser.set_defaults(**flat_defaults)
    params = get_structured_params(vars(parser.parse_args(argv)))
    postprocessors = []
    for x in params["postprocessors"]:
        cls = getattr(postprocess_module, x)
        postprocessors.append(cls(**pass_device(cls, params.get(x, {}),
                                                params["device"])))
    return output_samples(params["generator_path"], params["num_samples"],
                          postprocessors, params["description"],
                          params["random_seed"], params["result_dir"],
                          params["minibatch"], params["inference_chain"],
                          params["device"], params["truncation_psi"])


if __name__ == "__main__":
    cli_main()

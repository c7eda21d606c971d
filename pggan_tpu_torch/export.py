"""Export a generator into a self-contained ``torch.export`` artifact: the
counterpart of ``pggan_tpu/export.py``.

``export_generator`` traces ``G.forward`` at a fixed (depth, alpha) with
``torch.export``: the program holds the weights and the (batch, latent) ->
NHWC image graph, and runs under any PyTorch of a compatible version
without this package, its model code or a pickle of a live module.

Artifact layout (``<out>.pt2`` + ``<out>.json``):

- ``torch.export.save`` of the ``ExportedProgram``;
- a JSON sidecar with the JAX sidecar's keys where they apply (source
  snapshot, depth, alpha, resolution, batch or ``"polymorphic"``,
  latent_size, format, platforms, ``in_avals`` / ``out_avals``, the torch
  version, artifact bytes), so serving infrastructure can route requests
  without loading the program.

The program takes one ``(batch, latent_size) float32`` argument and returns
``(batch, H, W, C) float32``. ``batch`` is frozen at export time, or, with
``batch <= 0``, symbolic (``Dim("b")``): one artifact serves any batch.
Alpha 1 exports the fade-free graph.

The artifact holds PyTorch operators only, as JAX's holds only portable
XLA (``pggan_tpu/export.py:27-33``): a kernel reached through ``ctypes``
cannot be traced, and the artifact must not need this package's library.
So the export turns the NHCW tail off (and the serve's chain with it) and
calls ``G(..., kernels=False)``, which runs the NCHW upsample on its plain
version and the NCHW convs on ``F.conv2d``: an argument only this module
sets, not a catch on failure. An ordinary forward of the same G on the
card still launches the upsample kernel and the wide conv kernel.

``platforms``: a ``torch.export`` program is traced on one device, so an
artifact is for one platform (``cpu`` or ``cuda``); more than one raises.
The program is traced where G's parameters are and, when the platform
asked for is another, moved there by ``torch.export.passes.
move_to_device_pass``. The move puts the weights on that device, so an
artifact for ``cuda`` is written on a host with a card (a G on the CPU
there may be exported for ``cuda``); without one it raises.
"""

from __future__ import annotations

import copy
import json
import os

import torch

PLATFORMS = ("cpu", "cuda")


class _Forward(torch.nn.Module):
    """G at a fixed (depth, alpha, fade), on PyTorch operators only."""

    def __init__(self, G, depth: int, alpha: float, fade: bool):
        super().__init__()
        self.G, self.depth, self.alpha, self.fade = G, depth, alpha, fade

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.G(z, self.depth, self.alpha, self.fade, kernels=False)


def exportable(G):
    """A copy of ``G`` without the NHCW tail and the chain, in eval mode:
    the graph ``export_generator`` traces, and the direct forward to hold
    an artifact against."""
    G = copy.deepcopy(G)
    G.pallas_tail = G.inference_chain = False
    return G.eval().requires_grad_(False)


def _platform(platforms, device: torch.device) -> str:
    if platforms is None or len(platforms) == 0:
        return device.type
    platforms = [str(p) for p in platforms]
    if len(platforms) > 1:
        raise ValueError(f"platforms {platforms}: a torch.export program is "
                         "traced on one device; export one artifact per "
                         "platform")
    if platforms[0] not in PLATFORMS:
        raise ValueError(f"platform {platforms[0]!r}: one of {PLATFORMS}")
    return platforms[0]


def export_generator(G, depth: int, alpha: float, batch: int, *,
                     platforms=None):
    """``torch.export`` of ``G`` at (depth, alpha): an ``ExportedProgram``
    of ``z (batch, latent_size) float32 -> NHWC images``. ``batch <= 0``
    exports a symbolic batch ``Dim("b")``. ``platforms`` None or one of
    ``("cpu",)`` / ``("cuda",)``: traced on G's device, then moved to the
    platform asked for."""
    alpha = float(torch.tensor(alpha, dtype=torch.float32))
    device = next(G.parameters()).device
    target = _platform(platforms, device)
    fade = alpha < 1.0  # stable snapshots export the fade-free graph
    module = _Forward(exportable(G), int(depth), alpha, fade)
    poly = int(batch) <= 0
    example = torch.zeros((4 if poly else int(batch), G.latent_size),
                          dtype=torch.float32, device=device)
    dynamic = ({"z": {0: torch.export.Dim("b", min=1)}} if poly else None)
    with torch.no_grad():
        program = torch.export.export(module, (example,),
                                      dynamic_shapes=dynamic)
    if target != device.type:
        from torch.export import passes
        if target == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda': the program's weights move "
                               "to the card, and this host has none")
        if not hasattr(passes, "move_to_device_pass"):
            raise RuntimeError(f"this torch ({torch.__version__}) cannot "
                               f"move a program from {device.type} to "
                               f"{target}: export on a {target} device")
        program = passes.move_to_device_pass(program, target)
    return program


def program_platform(program) -> str:
    """The device type a program's weights are on: its platform."""
    devices = {t.device.type for t in program.state_dict.values()}
    if len(devices) != 1:
        raise ValueError(f"weights on {sorted(devices)}")
    return devices.pop()


def _avals(specs) -> list:
    """``dtype[dims]`` of each tensor placeholder or output, as the JAX
    sidecar writes its avals; the symbolic batch as ``b``."""
    out = []
    for node in specs:
        val = node.meta.get("val")
        if val is None or not hasattr(val, "shape"):
            continue
        dims = ",".join(str(d) if isinstance(d, int) else "b"
                        for d in val.shape)
        out.append(f"{str(val.dtype).replace('torch.', '')}[{dims}]")
    return out


def program_avals(program) -> tuple:
    """(inputs, outputs) of ``program`` as ``dtype[dims]`` strings (user
    inputs only, not the weights)."""
    user = set(program.graph_signature.user_inputs)
    nodes = list(program.graph.nodes)
    ins = [n for n in nodes if n.op == "placeholder" and n.name in user]
    out, = [n for n in nodes if n.op == "output"]
    outs = [a for a in out.args[0] if hasattr(a, "meta")]
    return _avals(ins), _avals(outs)


def save_exported(program, out_path: str, meta: dict) -> tuple[str, str]:
    """Write ``program`` to ``out_path`` (``.pt2`` appended if missing) and
    its JSON sidecar; returns ``(artifact_path, sidecar_path)``."""
    if not out_path.endswith(".pt2"):
        out_path = out_path + ".pt2"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path[:-len(".pt2")] + ".tmp.pt2"
    torch.export.save(program, tmp)
    os.replace(tmp, out_path)
    ins, outs = program_avals(program)
    info = dict(meta)
    info.update({
        "format": "torch.export ExportedProgram (.pt2)",
        "platforms": [program_platform(program)],
        "in_avals": ins,
        "out_avals": outs,
        "torch_version": torch.__version__,
        "artifact_bytes": os.path.getsize(out_path),
    })
    sidecar = os.path.splitext(out_path)[0] + ".json"
    with open(sidecar + ".tmp", "w") as f:
        json.dump(info, f, indent=1, sort_keys=True)
    os.replace(sidecar + ".tmp", sidecar)
    return out_path, sidecar


def load_exported(path: str):
    """The ``ExportedProgram`` of an artifact; run it with
    ``.module()(z)``."""
    return torch.export.load(path)

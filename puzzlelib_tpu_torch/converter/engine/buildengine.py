"""AOT inference-engine builder (counterpart of
``puzzlelib_tpu/converter/engine/buildengine.py``).

The whole net is traced once in eval mode with ``torch.export`` (non-strict:
the net's Python runs on fake tensors, PuzzleLib's ``Module.__call__``
included), the tensors it reads baked in as constants as a TensorRT engine
freezes its weights, and the program is saved with ``torch.export.save``:

- ``<name>.<dtype>.engine``: the exported program, which ``Engine`` loads;
- ``<name>.<dtype>.spec.json``: ``name``, ``dtype``, ``inshape``,
  ``outshape``, as the reference writes it;
- ``<name>.<dtype>.graph.txt``: the exported graph's code, with each value's
  type and shape;
- ``<name>.<dtype>.program`` and ``<name>.<dtype>.weights``: the same graph
  as text and its tensors as one blob (``program.py``), which the native
  host driver (``src/engine_driver.cpp``) runs without Python.  They take
  the place of the reference's ``.stablehlo.mlir``, which its PJRT driver
  reads.

The hand kernels appear in the graph as their custom operators
(``puzzlelib::matmul``, ``puzzlelib::matmul_nt`` for the int8 products,
``puzzlelib::winograd_conv2d``, ``puzzlelib::flash``), so a loaded engine
launches them as the eager net does.  Under ``Config.*Algo = "auto"`` the
trace takes each call's route from the measured tables as they stand at
build time, and the engine keeps those routes: a race run after the build
changes nothing in it.  An exported program records the
device it was traced on: build an engine on the device where it serves.
The net's tensors are read through a closure, not registered on the traced
module, so only the tensors the forward uses are saved: an int8 engine holds
its int8 weight tables, their scales and the biases, not the f32 weights.
"""

import json
import os

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.device import getDevice
from puzzlelib_tpu_torch.converter.engine.program import fromExported


class DataType:
    float32 = "float32"
    float16 = "float16"
    bfloat16 = "bfloat16"
    int8 = "int8"


_HALF = {DataType.float16: torch.float16, DataType.bfloat16: torch.bfloat16}
_NAMES = {torch.float32: DataType.float32, torch.float16: DataType.float16, torch.bfloat16: DataType.bfloat16,
          torch.int8: DataType.int8}


def _dtypeName(dtype):
    """The engine type's name from a name (a ``DataType`` entry) or a torch or
    numpy type (numpy has no bfloat16: name it)."""
    if isinstance(dtype, torch.dtype):
        name = _NAMES.get(dtype)
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name

    if name not in (DataType.float32, DataType.float16, DataType.bfloat16, DataType.int8):
        raise ValueError("engines are built in float32, float16, bfloat16 or int8, got %s" % (dtype, ))

    return name


def _quantizableModules(net):
    from puzzlelib_tpu_torch.containers.container import Container
    from puzzlelib_tpu_torch.modules.convnd import ConvND
    from puzzlelib_tpu_torch.modules.linear import Linear

    mods = []

    def walk(mod):
        if isinstance(mod, Container):
            for child in mod._modules.values():
                walk(child)
        elif isinstance(mod, (Linear, ConvND)):
            mods.append(mod)

    walk(net)
    return mods


def _patchQuantized(modules, scales):
    """Swap each module's updateData for the int8 path; returns a restore fn.

    Weights are quantized per output channel ahead of time, on the host as in
    the reference, and go to the module's device as int8 tables; the
    calibrated activation scale comes from ``scales[id(mod)]``.  Each table
    is laid out here once as the K-major operand B^T that K1-int8 on
    ``wgmma`` takes: a ``Linear``'s as (out, in) (``quant.linearOperand``), a
    conv's as ``quant.convOperand`` gives it, each with K padded with zeros
    to a multiple of 16.
    """
    from puzzlelib_tpu_torch.modules.linear import Linear
    from puzzlelib_tpu_torch.ops import quant

    own = {}

    for mod in modules:
        own[id(mod)] = mod.__dict__.get("updateData")
        device = mod.W.device

        xscale = torch.tensor(scales[id(mod)], dtype=torch.float32, device=device)
        w = gpuarray.get(mod.W)
        bias = mod.b.detach().float().reshape(-1) if mod.useBias else None

        if isinstance(mod, Linear):
            wq, wscale = quant.quantizeWeight(w, 0 if mod.transpose else 1)

            def patched(data, mod=mod, wt=quant.linearOperand(torch.from_numpy(wq), mod.transpose).to(device),
                        wscale=torch.from_numpy(wscale.reshape(-1)).to(device), xscale=xscale, bias=bias):
                mod.data = quant.quantLinear(data, wt, wscale, xscale, bias)

        else:
            wq, wscale = quant.quantizeWeight(w, axis=0)

            def patched(data, mod=mod, wmat=quant.convOperand(torch.from_numpy(wq), mod.groups).to(device),
                        ksize=wq.shape[2:], wscale=torch.from_numpy(wscale.reshape(-1)).to(device), xscale=xscale,
                        bias=bias):
                mod.data = quant.quantConvNd(data, wmat, ksize, wscale, xscale, bias, stride=tuple(mod.stride),
                                             pad=tuple(mod.pad), dilation=tuple(mod.dilation))

        mod.updateData = patched

    def restore():
        for mod in modules:
            if own[id(mod)] is None:
                del mod.updateData
            else:
                mod.updateData = own[id(mod)]

    return restore


def _functionalForward(net):
    def forward(x):
        out = net(x)
        net.reset()
        return out

    return forward


class _Program(torch.nn.Module):
    """What is traced: f32 in, the net's output in f32 out, the input cast to
    the engine's type first for a half-precision engine.  The net is reached
    through ``forward``'s closure only, so that ``torch.export`` keeps the
    tensors the trace reads as constants and no other parameter of it."""

    def __init__(self, forward, castInputTo):
        super().__init__()
        self.run, self.castInputTo = forward, castInputTo

    def forward(self, x):
        out = self.run(x if self.castInputTo is None else x.to(self.castInputTo))
        return out.float()


def _netDevice(net):
    param = next(net.parameters(), None)
    return getDevice() if param is None else param.device


def halfClone(net, dtype):
    """A copy of ``net`` in eval mode and ``calcMode(dtype)``, made as the
    reference makes it (``blueprint.load(net.save(withBlueprint=True))``):
    rebuilt from its blueprint, its variables and attributes carried across
    by ``save`` and ``load``.  They go through an in-memory store
    (``hdf.MemoryStore``), neither through a file nor through a string
    dataset, so no ``h5py`` is needed.  ``net`` is left as it was."""
    from puzzlelib_tpu_torch.blueprint import BlueprintFactory
    from puzzlelib_tpu_torch.hdf import MemoryStore

    clone = BlueprintFactory().build(net.getBlueprint())
    device = _netDevice(net)
    if _netDevice(clone) != device:
        clone.to(device)

    store = MemoryStore()
    net.save(store)
    clone.load(store)

    clone.evalMode()
    clone.calcMode(dtype)
    return clone


def buildEngine(net, inshape, savepath, dtype=DataType.float32, name=None, returnEngine=True,
                calibrator=None):
    """Trace, export and save ``net`` for the given input shape, on the
    device its parameters are on.

    Produces ``<name>.<dtype>.engine`` (``torch.export``, loadable by
    ``Engine``), ``<name>.<dtype>.spec.json``, ``<name>.<dtype>.graph.txt``
    and, for the native driver, ``<name>.<dtype>.program`` and
    ``<name>.<dtype>.weights``.  Input and output are f32 whatever the
    engine's type.

    ``dtype="int8"`` (with a ``DataCalibrator``) quantizes Linear and Conv
    weights per output channel and activations per tensor with calibrated
    scales; every integer product runs on K1-int8.  ``float16`` and
    ``bfloat16`` trace a ``calcMode``-cast copy made through the net's
    blueprint (``halfClone``), so the user's f32 net keeps its weights.  The user's net is restored after the build.
    """
    if name is None:
        name = net.name or "net"

    net.evalMode()
    dtype = _dtypeName(dtype)

    restore, castInputTo = None, None
    if dtype == DataType.int8:
        if calibrator is None:
            raise ValueError("int8 engines require a DataCalibrator for activation ranges")

        modules = _quantizableModules(net)
        scales = calibrator.calibrate(net, modules)
        restore = _patchQuantized(modules, scales)

    elif dtype in _HALF:
        net = halfClone(net, _HALF[dtype])
        castInputTo = _HALF[dtype]

    program = _Program(_functionalForward(net), castInputTo)
    example = torch.zeros(tuple(inshape), dtype=torch.float32, device=_netDevice(net))

    try:
        exported = torch.export.export(program, (example, ), strict=False)
    finally:
        if restore is not None:
            restore()

    base = os.path.join(savepath, "%s.%s" % (name, dtype))

    # the program keeps its example input, which the file would carry (19 MB
    # for VGG at batch 32); an engine needs none
    exported.example_inputs = None

    enginepath = base + ".engine"
    with open(enginepath, "wb") as f:
        torch.export.save(exported, f)

    with open(base + ".graph.txt", "w") as f:
        f.write(exported.graph_module.print_readable(print_output=False))

    fromExported(exported).save(base + ".program", base + ".weights")

    output = next(node for node in exported.graph.nodes if node.op == "output")
    with open(base + ".spec.json", "w") as f:
        json.dump({
            "name": name,
            "dtype": dtype,
            "inshape": list(inshape),
            "outshape": list(output.args[0][0].meta["val"].shape),
        }, f, indent=2)

    if returnEngine:
        from puzzlelib_tpu_torch.converter.engine.engine import Engine
        return Engine(enginepath)

    return enginepath

"""The glue, upsampling and unpooling layers, the LRN family, the spatial
transformer, ``GroupLinear``, the noise and penalty layers and the 1-d and
3-d modules one by one, as ``chip_smoke.py`` [layers] and the tests run
them.

Each case of ``CASES`` builds a module of the port (or of any package with
the same module API: the tests build the JAX package's from the same
builders), feeds it seeded inputs and a seeded output gradient, and keeps
its output, its input gradient and every parameter gradient (``run``).
``FULL`` gives the shapes at which [layers] runs each case on the card and
on the CPU; ``exact`` marks the cases that only move data (and whose
backward adds, if it adds, elementwise in a fixed order), whose card run
must give the CPU's bits (``held``); the others are held to the twins'
tiers, 1e-5 of max(1, max |CPU|) in f32 and 5e-2 in bf16.

The pool and k-max cases read relu outputs, so that whole windows and
lines tie at 0.  In bf16 the inputs are rounded to bf16 first, so that
both runs (and an f32 reference) see the same values.  A case runs in the
types its module takes (``dtypes``: the LRN family, ``SubtractMean``,
``LCN``, ``SpatialTf``, ``GroupLinear`` and ``Penalty`` take f32 only, as
in the JAX package).  The LRN cases take alpha = 1, so that the window's
term weighs in the gradient.  ``SpatialTf``'s transforms are the identity
plus small seeded shifts for the first half of the batch and large ones,
which reach outside the image, for the second.  ``NoiseInjector`` draws
from a seeded numpy stream (``SeededRng``), the same on every device and in
both packages.
"""

import numpy as np


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}

GLUE_SIZE = 1024


class Case:
    """``build(modules, containers, dtype)`` -> the module; ``relu``: the
    inputs are relu outputs; ``many``: the module takes a list; ``exact``:
    the module only moves data; ``calcMode``: the module takes the net's
    type (a ``Cast`` has its own); ``dtypes``: the types it takes;
    ``shape(arrays)``: the inputs made from the seeded normals."""

    def __init__(self, build, relu=False, many=False, exact=True, calcMode=True, dtypes=("f32", "bf16"),
                 shape=None):
        self.build, self.relu, self.many, self.exact, self.calcMode = build, relu, many, exact, calcMode
        self.dtypes, self.shape = dtypes, shape


def _poolUnpool(M, C, size, stride):
    net = C.Sequential(name="poolunpool")
    pool = M.MaxPool2D(size, stride, useMask=True, name="pool")
    net.append(pool)
    net.append(M.MaxUnpool2D(pool, name="unpool"))
    return net


def _glue(M):
    def bwdGlue(grad, modules):
        modules["lin"].backward(grad)
        return modules["lin"].grad

    return M.Glue(modules={"lin": M.Linear(GLUE_SIZE, GLUE_SIZE, name="lin")},
                  fwdGlue=lambda data, modules: modules["lin"](data), bwdGlue=bwdGlue,
                  fwdShapeGlue=lambda shape: shape, bwdShapeGlue=lambda shape: shape)


def _cast(M, dtype):
    return M.Cast("float32", "bfloat16") if dtype == "f32" else M.Cast("bfloat16", "float32")


class SeededRng:
    """A stand-in for either package's ``rng``: its fills write draws of a
    numpy stream seeded by ``seed`` and the call count, uniform over [a, b)
    or normal, in f32, into a torch tensor or a JAX package's array."""

    def __init__(self, seed=7):
        self.seed, self.calls = seed, 0

    def _draws(self, shape, kind, p, q):
        self.calls += 1
        rng = np.random.RandomState([self.seed, self.calls])
        draws = rng.uniform(p, q, size=shape) if kind == "uniform" else rng.normal(p, q, size=shape)
        return draws.astype(np.float32)

    @staticmethod
    def _write(data, ary):
        import torch

        if isinstance(data, torch.Tensor):
            data.copy_(torch.from_numpy(ary))
        else:
            data.set(ary)

    def fillUniform(self, data, minval=0.0, maxval=1.0):
        self._write(data, self._draws(tuple(data.shape), "uniform", minval, maxval))

    def fillNormal(self, data, mean=0.0, sigma=1.0):
        self._write(data, self._draws(tuple(data.shape), "normal", mean, sigma))


def _transforms(arrays):
    """(images, transforms): the identity plus 0.05 times the normals for
    the first half of the batch, plus 0.6 times them (reaching outside the
    image) for the second."""
    images, noise = arrays
    scale = np.where(np.arange(len(noise)) < len(noise) // 2, 0.05, 0.6).astype(np.float32)[:, None, None]
    return [images, (np.array([[1, 0, 0], [0, 1, 0]], np.float32) + scale * noise[:, :2, :3]).astype(np.float32)]


def _groupLinear(M, batchDim, wmode, groups=None, size=None):
    groups, size = groups or GROUPS, size or GROUP_SIZE
    return M.GroupLinear(groups, size, size, wmode=wmode, batchDim=batchDim, initscheme="he")


def _lrn(M, cls, N, K):
    return getattr(M, cls)(N=N, alpha=1.0, beta=0.75, K=K)


F32 = ("f32", )
GROUPS, GROUP_SIZE = 16, 512

CASES = {
    "DepthConcat": Case(lambda M, C, dt: M.DepthConcat(), many=True),
    "Split": Case(lambda M, C, dt: M.Split(axis=0, sections=(16, 32, 16))),
    "Slice": Case(lambda M, C, dt: M.Slice()[:, 2:-2, 1:-1]),
    "Tile": Case(lambda M, C, dt: M.Tile(axis=1, times=3)),
    "Transpose": Case(lambda M, C, dt: M.Transpose((0, 2, 1))),
    "MoveAxis": Case(lambda M, C, dt: M.MoveAxis(0, 2)),
    "Mul": Case(lambda M, C, dt: M.Mul(), many=True, exact=False),
    "Glue": Case(lambda M, C, dt: _glue(M), exact=False),
    "Cast": Case(lambda M, C, dt: _cast(M, dt), calcMode=False),
    "Pad2D reflect": Case(lambda M, C, dt: M.Pad2D(1, mode="reflect")),
    "Pad2D constant": Case(lambda M, C, dt: M.Pad2D(1, mode="constant", fillValue=0.5)),
    "PRelu": Case(lambda M, C, dt: M.PRelu(64), exact=False),
    "PRelu shared": Case(lambda M, C, dt: M.PRelu(64, sharedMaps=True), exact=False),
    "Upsample2D nearest": Case(lambda M, C, dt: M.Upsample2D(2, mode="nearest")),
    "Upsample2D linear": Case(lambda M, C, dt: M.Upsample2D(2, mode="linear"), exact=False),
    "Upsample3D nearest": Case(lambda M, C, dt: M.Upsample3D(2, mode="nearest")),
    "Upsample3D linear": Case(lambda M, C, dt: M.Upsample3D(2, mode="linear"), exact=False),
    "MaxPool2D-MaxUnpool2D 2x2/2": Case(lambda M, C, dt: _poolUnpool(M, C, 2, 2), relu=True),
    "MaxPool2D-MaxUnpool2D 3x3/2": Case(lambda M, C, dt: _poolUnpool(M, C, 3, 2), relu=True),
    "KMaxPool": Case(lambda M, C, dt: M.KMaxPool(topk=5, axis=2), relu=True),
    "CrossMapLRN N=5": Case(lambda M, C, dt: _lrn(M, "CrossMapLRN", 5, 2.0), exact=False, dtypes=F32),
    "CrossMapLRN N=4": Case(lambda M, C, dt: _lrn(M, "CrossMapLRN", 4, 1.0), exact=False, dtypes=F32),
    "MapLRN": Case(lambda M, C, dt: _lrn(M, "MapLRN", 5, 2.0), exact=False, dtypes=F32),
    "SubtractMean": Case(lambda M, C, dt: M.SubtractMean(7), exact=False, dtypes=F32),
    "SubtractMean no pad": Case(lambda M, C, dt: M.SubtractMean(7, includePad=False), exact=False, dtypes=F32),
    "LCN": Case(lambda M, C, dt: M.LCN(N=7, alpha=1.0), exact=False, dtypes=F32),
    "LCN no pad": Case(lambda M, C, dt: M.LCN(N=7, alpha=1.0, includePad=False), exact=False, dtypes=F32),
    "SpatialTf": Case(lambda M, C, dt: M.SpatialTf(), many=True, exact=False, dtypes=F32, shape=_transforms),
    "SpatialTf 112": Case(lambda M, C, dt: M.SpatialTf(shape=(3, 112, 112)), many=True, exact=False, dtypes=F32,
                          shape=_transforms),
    "GroupLinear batchDim 0": Case(lambda M, C, dt: _groupLinear(M, 0, "full"), exact=False, dtypes=F32),
    "GroupLinear batchDim 1": Case(lambda M, C, dt: _groupLinear(M, 1, "full"), exact=False, dtypes=F32),
    "GroupLinear wmode one": Case(lambda M, C, dt: _groupLinear(M, 0, "one"), exact=False, dtypes=F32),
    "GroupLinear wmode one batchDim 1": Case(lambda M, C, dt: _groupLinear(M, 1, "one"), exact=False, dtypes=F32),
    "Penalty l1": Case(lambda M, C, dt: M.Penalty("l1", weight=0.5), relu=True, exact=False, dtypes=F32),
    "Penalty l2": Case(lambda M, C, dt: M.Penalty("l2", weight=0.5), relu=True, exact=False, dtypes=F32),
    "NoiseInjector add uniform": Case(lambda M, C, dt: M.NoiseInjector("add", "uniform", (-0.5, 0.5),
                                                                         rng=SeededRng()), exact=False),
    "NoiseInjector add normal": Case(lambda M, C, dt: M.NoiseInjector("add", "gaussian", (0.0, 0.5),
                                                                        rng=SeededRng()), exact=False),
    "NoiseInjector mul uniform": Case(lambda M, C, dt: M.NoiseInjector("mul", "uniform", (0.5, 1.5),
                                                                         rng=SeededRng()), exact=False),
    "NoiseInjector mul normal": Case(lambda M, C, dt: M.NoiseInjector("mul", "gaussian", (1.0, 0.1),
                                                                        rng=SeededRng()), exact=False),
    "Deconv1D": Case(lambda M, C, dt: M.Deconv1D(256, 128, 4, stride=2, pad=1, initscheme="he"), exact=False),
    "Deconv3D": Case(lambda M, C, dt: M.Deconv3D(256, 128, 3, stride=2, pad=1, postpad=1, initscheme="he"),
                     exact=False),
    "MaxPool3D 2x2x2/2": Case(lambda M, C, dt: M.MaxPool3D(2, 2), relu=True),
    "MaxPool3D 3x3x3/2": Case(lambda M, C, dt: M.MaxPool3D(3, 2, pad=1), relu=True, exact=False),
    "MaxPool3D C3D pool5": Case(lambda M, C, dt: M.MaxPool3D(2, 2, pad=(0, 1, 1)), relu=True),
    "AvgPool3D 2x2x2/2": Case(lambda M, C, dt: M.AvgPool3D(2, 2), exact=False),
    "AvgPool3D 3x3x3/2": Case(lambda M, C, dt: M.AvgPool3D(3, 2, pad=1, includePad=False), exact=False),
    "MaxPool1D 5/2": Case(lambda M, C, dt: M.MaxPool1D(5, 2, pad=2), relu=True, exact=False),
    "AvgPool1D 5/2": Case(lambda M, C, dt: M.AvgPool1D(5, 2, pad=2, includePad=False), exact=False),
}

_SEGNET_MAPS = (4, 64, 360, 480)
_BIG = (64, 256, 256)   # 16 MiB in f32
_ALEXNET_MAPS = (128, 96, 55, 55)   # AlexNet's conv1 output at batch 128
_IMAGES = (32, 3, 224, 224)
_CLIPS = (16, 64, 16, 112, 112)   # C3D's conv1a output at batch 16

# [layers]' shapes: a list of input shapes a case
FULL = {
    "DepthConcat": [(32, 64, 28, 28), (32, 128, 26, 26), (32, 32, 24, 24)],
    "Split": [_BIG], "Slice": [_BIG], "Tile": [_BIG], "Transpose": [_BIG], "MoveAxis": [_BIG],
    "Mul": [_BIG] * 3, "Glue": [(4096, GLUE_SIZE)], "Cast": [(4, 12, 360, 480)],
    "Pad2D reflect": [_SEGNET_MAPS], "Pad2D constant": [_SEGNET_MAPS],
    "PRelu": [_SEGNET_MAPS], "PRelu shared": [_SEGNET_MAPS],
    "Upsample2D nearest": [(4, 256, 90, 120)], "Upsample2D linear": [(4, 256, 90, 120)],
    "Upsample3D nearest": [(2, 64, 16, 56, 56)], "Upsample3D linear": [(2, 64, 16, 56, 56)],
    "MaxPool2D-MaxUnpool2D 2x2/2": [_SEGNET_MAPS], "MaxPool2D-MaxUnpool2D 3x3/2": [_SEGNET_MAPS],
    "KMaxPool": [(64, 300, 100)],
    "CrossMapLRN N=5": [_ALEXNET_MAPS], "CrossMapLRN N=4": [_ALEXNET_MAPS], "MapLRN": [_ALEXNET_MAPS],
    "SubtractMean": [_IMAGES], "SubtractMean no pad": [_IMAGES], "LCN": [_IMAGES], "LCN no pad": [_IMAGES],
    "SpatialTf": [(64, 3, 224, 224), (64, 2, 3)], "SpatialTf 112": [(64, 3, 224, 224), (64, 2, 3)],
    "GroupLinear batchDim 0": [(64, GROUPS, GROUP_SIZE)], "GroupLinear batchDim 1": [(GROUPS, 64, GROUP_SIZE)],
    "GroupLinear wmode one": [(64, GROUPS, GROUP_SIZE)],
    "GroupLinear wmode one batchDim 1": [(GROUPS, 64, GROUP_SIZE)],
    "Penalty l1": [(128, 4096)], "Penalty l2": [(128, 4096)],
    "NoiseInjector add uniform": [(128, 4096)], "NoiseInjector add normal": [(128, 4096)],
    "NoiseInjector mul uniform": [(128, 4096)], "NoiseInjector mul normal": [(128, 4096)],
    "Deconv1D": [(16, 256, 800)], "Deconv3D": [(4, 256, 8, 28, 28)],
    "MaxPool3D 2x2x2/2": [_CLIPS], "MaxPool3D 3x3x3/2": [_CLIPS], "MaxPool3D C3D pool5": [(16, 512, 2, 7, 7)],
    "AvgPool3D 2x2x2/2": [_CLIPS], "AvgPool3D 3x3x3/2": [_CLIPS],
    "MaxPool1D 5/2": [(8, 250, 800)], "AvgPool1D 5/2": [(8, 250, 800)],
}


def bf16Values(ary):
    """``ary`` rounded to bf16 and back to f32 (through torch: the port does
    not import ``ml_dtypes``)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(ary)).to(torch.bfloat16).float().numpy()


def _normals(shapes, seed):
    """Seeded f32 unit normals of ``shapes``, from torch's CPU generator
    (several times faster than numpy's at [layers]' sizes)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).numpy() for shape in shapes]


def _typed(arrays, dtype):
    return [bf16Values(ary) for ary in arrays] if dtype == "bf16" else arrays


def _relued(name, arrays):
    case = CASES[name]
    arrays = [np.maximum(ary, 0) for ary in arrays] if case.relu else arrays
    return case.shape(arrays) if case.shape is not None else arrays


def inputs(name, shapes, dtype, seed=1):
    """The case's seeded f32 inputs (relu outputs for ``relu`` cases), bf16
    values for "bf16"."""
    return _typed(_relued(name, _normals(shapes, seed)), dtype)


def outGrads(shapes, dtype, seed=9):
    """Seeded f32 output gradients of ``shapes`` (bf16 values for "bf16")."""
    return _typed(_normals(shapes, seed), dtype)


def _paramGrads(mod):
    """The gradient buffers of the module's variables and of a Glue's
    inner modules', by name."""
    grads = {name: var.grad for name, var in mod.vars.items()}

    for inner, child in (getattr(mod, "glueModules", None) or {}).items():
        grads.update({"%s.%s" % (inner, name): var.grad for name, var in child.vars.items()})

    return grads


def run(name, shapes, dtype, device=None, seed=1, feed=None):
    """The case on the port at ``shapes`` in ``dtype`` ("f32" or "bf16") on
    ``device`` (the caller's ``Config.device`` by default): {"out": [the
    outputs], "grad": [the input gradients], "params": {name: gradient}},
    tensors on the device.  ``feed``, a dict, keeps the host inputs and
    output gradients of the first run for the next runs of the case, in
    either type, and for other cases of the same inputs (``feedKey``), the
    output gradients by their shapes.
    Clears ``Config.globalEvalMode``: the parameter gradients need their
    buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch import containers, modules
    from puzzlelib_tpu_torch.backend.device import getDevice

    case, ttype = CASES[name], {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    Config.globalEvalMode = False
    if device is not None:
        Config.device = device
    device = getDevice()

    np.random.seed(seed)
    mod = case.build(modules, containers, dtype)
    if dtype != "f32" and case.calcMode:
        mod.calcMode(ttype)

    feed = {} if feed is None else feed
    if "normals" not in feed:
        feed["normals"] = _relued(name, _normals(shapes, seed))
    if ("inputs", dtype) not in feed:
        feed["inputs", dtype] = _typed(feed["normals"], dtype)

    xs = [torch.from_numpy(ary).to(device, ttype) for ary in feed["inputs", dtype]]
    out = mod(xs if case.many else xs[0])
    outs = out if isinstance(out, list) else [out]

    outShapes = tuple(tuple(o.shape) for o in outs)
    if ("gradNormals", outShapes) not in feed:
        feed["gradNormals", outShapes] = _normals(outShapes, 9)
    if ("grads", outShapes, dtype) not in feed:
        feed["grads", outShapes, dtype] = _typed(feed["gradNormals", outShapes], dtype)

    grads = [torch.from_numpy(g).to(device, outs[0].dtype) for g in feed["grads", outShapes, dtype]]
    mod.backward(grads if isinstance(out, list) else grads[0])

    ingrads = mod.grad if isinstance(mod.grad, list) else [mod.grad]
    return {"out": list(outs), "grad": list(ingrads), "params": _paramGrads(mod)}


def feedKey(name, shapes):
    """The cases whose ``run`` may share a feed have the same key: the same
    input shapes, made from the normals the same way."""
    case = CASES[name]
    return tuple(map(tuple, shapes)), case.relu, case.shape


def _pairs(got, want):
    return ([("out %d" % i, g, w) for i, (g, w) in enumerate(zip(got["out"], want["out"]))] +
            [("grad %d" % i, g, w) for i, (g, w) in enumerate(zip(got["grad"], want["grad"]))] +
            [(name, got["params"][name], want["params"][name]) for name in sorted(want["params"])])


def held(name, got, want, dtype):
    """[(what, bit-equal, error against max(1, max |want|))] of ``got``
    against ``want`` (``run``'s results on two devices), and whether the
    case holds: bit-equal for an ``exact`` case, within BOUNDS otherwise.
    The comparison runs on ``got``'s device."""
    import torch

    rows = []
    for what, g, w in _pairs(got, want):
        g, w = g.detach(), w.detach().to(g.device)
        same = tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype and torch.equal(g, w)
        err = (g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
        rows.append((what, same, err))

    ok = all(same if CASES[name].exact else err <= BOUNDS[dtype] for _, same, err in rows)
    return rows, ok

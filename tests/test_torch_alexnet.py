"""The AlexNet and C3D slices against the JAX package: ``tools/alexnetslice.py``'s
builder at widths 8 to 32 on 3 x 67 x 67 images (the LRNs, the grouped convs
and the overlapping pools at full depth) and ``tools/c3dslice.py``'s at
widths 4 to 16 on 3 x 16 x 32 x 32 clips (16 frames: pool5's 2 x 2 x 2
window needs 2 frames after four pools, which 8 frames do not leave), each to
10 classes.

Each twin builds the JAX net and the port's from the same builder, loads
``zooslice.heTable``'s He weights into both and injects the same dropout
draws into both.  It holds the train-mode output, ``CrossEntropy``'s loss
and gradient, the input gradient, every parameter gradient and
``dataShapeFrom``: f32 within 1e-5 of max(1, max |want|); C3D in bf16 within
5e-2 of the JAX package's f32 run on the same bf16 values (the output, the
loss and the input gradient) and of its bf16 run (every parameter
gradient too).  A JAX C3D's
weight table loads into the port's net (``convert.paramsFromNumpy``) and
gives the same forward; ``GroupLinear``'s (groups, rows, cols) table and the
1-d and 3-d deconvs' tables go both ways.  The card-only case (``cuda``
marker) trains and serves both narrow nets on each route."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.tools import alexnetslice, c3dslice, zooslice

import layertwins as LT


CLASSES, BATCH = 10, 4
NETS = {
    "alexnet": (alexnetslice, dict(maps=(8, 16, 24, 24, 16), fcs=(32, 32), classes=CLASSES, shape=(3, 67, 67))),
    "c3d": (c3dslice, dict(maps=(4, 8, 8, 16, 16), fcs=(16, 16), classes=CLASSES, shape=(3, 16, 32, 32))),
}


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


def _jax():
    pytest.importorskip("puzzlelib_tpu.cost", reason="the twins need the JAX package")
    from puzzlelib_tpu import cost

    return LT.jaxPackage() + (cost, )


class _Draws:
    """Seeded uint32 dropout draws per module name, in the order a module asks
    for them; one feed for each package, from the same seeds."""

    def __init__(self, seed=11):
        self.seed, self.calls = seed, {}

    def inject(self, mod, asTensor):
        def draw(size):
            call = self.calls[mod.name] = self.calls.get(mod.name, 0) + 1
            rng = np.random.RandomState([self.seed, call, sum(map(ord, mod.name))])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


def _twins(kind):
    """The JAX package's narrow net and the port's with the same He weights
    and the same dropout draws."""
    J, JC, jgpu, _, _ = _jax()
    NetSlice, widths = NETS[kind]
    jnet = NetSlice.buildNet(modules=J, containers=JC, **widths)
    tnet = NetSlice.buildNet(**widths)

    np.random.seed(0)
    table = zooslice.heTable(tnet)
    for var, names in jnet.getVarTable().items():
        var.data.set(table[names[0]])
    paramsFromNumpy(tnet, table)

    jdraws, tdraws = _Draws(), _Draws()
    for jmod, tmod in zip(jnet.graph, tnet.graph):
        if isinstance(tmod, T.Dropout):
            jdraws.inject(jmod, jgpu.to_gpu)
            tdraws.inject(tmod, lambda ary: torch.from_numpy(ary.astype(np.int64)))

    return jnet, tnet


def _data(kind):
    NetSlice, widths = NETS[kind]
    return NetSlice.data(BATCH, seed=3, shape=widths["shape"], classes=CLASSES)


def testStructureTwin():
    """Same modules, names and types, parameters and ``dataShapeFrom`` in
    both packages; the full-width nets' parameter counts and K1 routes."""
    for kind in NETS:
        jnet, tnet = _twins(kind)
        NetSlice, widths = NETS[kind]
        inshape = (BATCH, ) + widths["shape"]

        assert [(m.name, type(m).__name__) for m in tnet.graph] == [(m.name, type(m).__name__) for m in jnet.graph]
        assert tnet.numOfParams() == jnet.numOfParams()
        assert tuple(tnet.dataShapeFrom(inshape)) == tuple(jnet.dataShapeFrom(inshape)) == (BATCH, CLASSES)

    full = alexnetslice.buildNet()
    assert full.numOfParams() == 60965224 and full.dataShapeFrom((1, ) + alexnetslice.SHAPE) == (1, 1000)
    assert alexnetslice.linearLaunches(full, alexnetslice.BATCH) == {"fc6": (1, 0), "fc7": (1, 0), "fc8": (1, 0)}
    del full

    full = c3dslice.buildNet()
    assert full.numOfParams() == 79991015 and full.dataShapeFrom((1, ) + c3dslice.SHAPE) == (1, 487)
    assert full.getByName("pool5").dataShapeFrom((1, 512, 2, 7, 7)) == (1, 512, 1, 4, 4)
    full.calcMode(torch.bfloat16)
    assert alexnetslice.linearLaunches(full, c3dslice.BATCH) == {"fc6": (1, 1), "fc7": (1, 1), "fc8": (1, 0)}


def _step(net, x, labels, cost):
    """A train-mode forward, the cost's loss and gradient, and the backward:
    (out, loss, loss gradient, input gradient, {name: parameter gradient})."""
    out = net(x)
    err, grad = cost(out, labels)
    net.backward(grad)
    return out, np.float32(err), grad, net.grad, {names[0]: var.grad for var, names in net.getVarTable().items()}


def _forwardBackward(kind, dtype, jaxTypes):
    """``_step`` on the same dropout draws and the same (for bf16,
    bf16-rounded) images: the port's net in ``dtype`` once ("port") and the
    JAX package's in each of ``jaxTypes``."""
    _, _, jgpu, types, JCost = _jax()
    images, labels = _data(kind)
    images = LT.layerslice._typed([images], dtype)[0]

    runs = {}
    for jaxType in jaxTypes:
        jnet, tnet = _twins(kind)
        if jaxType != "f32":
            jnet.calcMode(types[jaxType])
        runs[jaxType] = _step(jnet, jgpu.to_gpu(images.astype(types[jaxType])), jgpu.to_gpu(labels),
                              JCost.CrossEntropy(maxlabels=CLASSES))

    ttype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    if dtype != "f32":
        tnet.calcMode(ttype)
    runs["port"] = _step(tnet, torch.from_numpy(images).to(ttype), torch.from_numpy(labels),
                         TCrossEntropy(maxlabels=CLASSES))
    assert runs["port"][0].dtype == ttype
    return runs


def _held(got, want, bound, params=True):
    for g, w in list(zip(got, want))[:4]:
        LT.close(g, w, bound)

    if params:
        assert sorted(got[4]) == sorted(want[4])
        for name in got[4]:
            LT.close(got[4][name], want[4][name], bound)


@pytest.mark.parametrize("kind", sorted(NETS))
def testForwardBackwardTwin(kind):
    """A train-mode forward on the same dropout draws, the cross-entropy's
    loss and gradient, and the backward in f32: the output, the input
    gradient and every parameter gradient within 1e-5."""
    runs = _forwardBackward(kind, "f32", ["f32"])
    _held(runs["port"], runs["f32"], LT.BOUNDS["f32"])


def testC3DBf16Twin():
    """C3D in bf16 against the JAX package: the output, the loss, its
    gradient and the input gradient within 5e-2 of the JAX package's f32
    run; every parameter gradient within 5e-2 of its bf16 run (the two
    packages' bf16 gradients agree to ~1e-4; each lies up to ~0.3 of the
    largest from its f32 run at the first convs, where bf16 rounding moves
    pooled maxima)."""
    runs = _forwardBackward("c3d", "bf16", ["f32", "bf16"])
    _held(runs["port"], runs["f32"], LT.BOUNDS["bf16"], params=False)
    _held(runs["port"], runs["bf16"], LT.BOUNDS["bf16"])


def testJaxWeightTableLoads():
    """A JAX C3D's weights (its own He init), read as a table, load into the
    port's C3D and give the same eval forward; the table comes back out
    unchanged."""
    J, JC, jgpu, _, _ = _jax()
    widths = NETS["c3d"][1]
    np.random.seed(5)
    jnet = c3dslice.buildNet(modules=J, containers=JC, **dict(widths, shape=widths["shape"]))
    for var, names in jnet.getVarTable().items():
        var.data.set(np.random.randn(*var.data.shape).astype(np.float32) * 0.2)

    table = {names[0]: var.data.get() for var, names in jnet.getVarTable().items()}
    tnet = c3dslice.buildNet(**widths)
    paramsFromNumpy(tnet, table)
    assert all(np.array_equal(paramsToNumpy(tnet)[name], ary) for name, ary in table.items())

    jnet.evalMode()
    tnet.evalMode()
    images, _ = _data("c3d")
    LT.close(tnet(torch.from_numpy(images)), jnet(jgpu.to_gpu(images)))


def testGroupAndDeconvTablesCarry():
    """``GroupLinear``'s (groups, rows, cols) table and bias, and the 1-d and
    3-d convs' and deconvs' tables, go from the JAX package into the port
    and back."""
    J, JC, _, _, _ = _jax()

    def build(M, C):
        np.random.seed(6)
        net = C.Sequential()
        for mod in (M.GroupLinear(3, 4, 5, name="group"), M.Conv1D(2, 3, 3, name="c1"),
                    M.Deconv1D(3, 2, 4, stride=2, name="d1"), M.Conv3D(2, 3, 3, name="c3"),
                    M.Deconv3D(3, 2, 2, stride=2, name="d3")):
            net.append(mod)
        return net

    jnet, tnet = build(J, JC), build(T, TC)
    table = {names[0]: var.data.get() for var, names in jnet.getVarTable().items()}
    assert table["group.W"].shape == (3, 4, 5) and table["group.b"].shape == (3, 5)

    paramsFromNumpy(tnet, table)
    back = paramsToNumpy(tnet)
    assert sorted(back) == sorted(table) and all(np.array_equal(back[name], table[name]) for name in table)


@pytest.mark.parametrize("kind", sorted(NETS))
def testSliceRoutesOnCpu(kind):
    """The narrow net through the slice's ``Run``: training on the hand and
    library routes gives the same losses on the CPU (both run the plain
    products there), the fused route the eager one's, and serving on each
    route the same scores."""
    NetSlice, widths = NETS[kind]
    net = NetSlice.build(**widths)
    run = alexnetslice.buildRun(net, batch=2, learnRate=1e-3, classes=CLASSES)
    images, labels = NetSlice.data(4, shape=widths["shape"], classes=CLASSES)

    losses = {algo: [] for algo in ("hopper", "torch", "fused")}
    for algo, seen in losses.items():
        run.train(algo, images, labels, seen)
    assert losses["hopper"] == losses["torch"] == losses["fused"] and np.isfinite(losses["hopper"]).all()

    scores = [run.serve(algo, images)[0] for algo in ("hopper", "torch", "fused")]
    assert scores[0].shape == (4, CLASSES) and all(np.array_equal(s, scores[0]) for s in scores)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(NETS))
def testNarrowSliceOnCard(monkeypatch, kind):
    """The narrow net on the card through each route: K1 launched once a
    forward on each Linear, the hand route's losses within the tiers of the
    library route's, the fused ones equal to eager's, the scores of the
    fused calculator equal to the eager one's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from puzzlelib_tpu_torch.ops.hopper import matmul

    monkeypatch.setattr(TConfig, "device", "cuda")
    NetSlice, widths = NETS[kind]
    dtype = torch.float32 if kind == "alexnet" else torch.bfloat16
    run = alexnetslice.buildRun(NetSlice.build(dtype, **widths), batch=2, learnRate=1e-3, classes=CLASSES)
    images, labels = NetSlice.data(4, shape=widths["shape"], classes=CLASSES)

    losses = {algo: [] for algo in ("hopper", "torch", "fused")}
    for algo, seen in losses.items():
        run.train(algo, images, labels)   # the fused route records its step here
        matmul.launches = 0
        run.train(algo, images, labels, seen)
        assert matmul.launches == (0 if algo == "torch" else 2 * 3)

    bound = 1e-4 if kind == "alexnet" else 5e-2
    assert max(abs(a - b) / abs(b) for a, b in zip(losses["hopper"], losses["torch"])) <= bound
    assert losses["fused"][0] == losses["hopper"][0]

    assert np.array_equal(run.serve("fused", images)[0], run.serve("hopper", images)[0])

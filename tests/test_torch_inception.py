"""The Inception slice against the JAX package: ``loadInceptionBN`` and
``loadInceptionV3`` by shape, Inception-BN's full-width forward at 224 x
224, a forward and backward twin of each block function that Inception-v3
runs (``bnBlock(typ="v3")``, ``bnShrinkBlock``, ``factorBlock``,
``v3ShrinkBlock``, ``expandBlock`` with its ``ToList``) at its full width
on a small map, and ``tools/inceptionslice.py``.

Each twin builds the JAX net and carries its weights and running stats
into the port's (``convert``); the data come from seeded numpy.  f32 is
held within 1e-5 of max(1, max |want|), the full-width chain within 1e-4
relative L2.  The card-only case (``cuda``
marker) serves Inception-BN through K1 and K2 against the library
route."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import attrsFromNumpy, attrsToNumpy, paramsFromNumpy
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.models.nets import inception as TInception
from puzzlelib_tpu_torch.tools import inceptionslice, resnetslice


F32_BOUND = 1e-5
CHAIN_BOUND = 1e-4


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.nets import inception

    return inception, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=F32_BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _relL2(got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jvars(jnet):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in jnet.getVarTable().items()
            for name in names}


def _jattrs(jnet, prefix=""):
    """The JAX net's module attributes by the names the port's
    ``getAttrTable`` gives them."""
    table = {}
    for name, child in getattr(jnet, "modules", {}).items():
        path = "%s%s." % (prefix, name)
        table.update({path + attr: np.asarray(value.get(), np.float32) for attr, value in child.attrs.items()})
        table.update(_jattrs(child, path))

    return table


def _carry(jnet, tnet):
    paramsFromNumpy(tnet, _jvars(jnet))
    attrsFromNumpy(tnet, _jattrs(jnet))


@pytest.mark.parametrize("kind, shape, out, nparams", [("bn", (1, 3, 224, 224), (1, 1000), 11285224),
                                                        ("v3", (1, 3, 299, 299), (1, 1008), 23850960)])
def testInceptionShapesTwin(monkeypatch, kind, shape, out, nparams):
    """The JAX package's shape checks (``tests/test_models.py``), and the
    same module names and types, variable and attribute names and shapes
    and parameter count in both packages."""
    JInception, _ = _jax()
    from puzzlelib_tpu import config as JConfig

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    load = "loadInceptionBN" if kind == "bn" else "loadInceptionV3"
    jnet, tnet = getattr(JInception, load)(None, initscheme="none"), getattr(TNets, load)(None, initscheme="none")

    assert tnet.dataShapeFrom(shape) == jnet.dataShapeFrom(shape) == out
    assert tnet.name == jnet.name
    assert [(m.name, type(m).__name__) for m in tnet.graph] == [(m.name, type(m).__name__) for m in jnet.graph]
    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    assert {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names} == jvars
    assert {name: tuple(a.shape) for name, a in tnet.getAttrTable().items()} == \
        {name: a.shape for name, a in _jattrs(jnet).items()}
    assert tnet.numOfParams() == jnet.numOfParams() == nparams

    with pytest.raises(NotImplementedError, match="checkpoint"):
        getattr(TNets, load)("inception.hdf")


def testInceptionBNForwardTwin():
    """Inception-BN at full width, 224 x 224 at batch 1, f32, the JAX net's
    He weights carried over, in train mode (every batch norm on its batch's
    stats, which it leaves in its running stats): the logits and the
    running stats within 1e-4 relative L2 of the JAX package's, the bound
    ``tests/test_torch_resnet.py`` holds ResNet-50's chain to (the logits
    read 1.06e-5 here: the two packages' f32 convs part by ~1e-7 a layer,
    and the batch norms at batch 1 carry that through 69 convs), the
    probabilities within 1e-5."""
    JInception, jgpu = _jax()

    np.random.seed(0)
    jnet = JInception.loadInceptionBN(None, initscheme="he")
    tnet = TNets.loadInceptionBN(None, initscheme="none")
    _carry(jnet, tnet)

    x = np.random.RandomState(2).randn(1, 3, 224, 224).astype(np.float32)
    jnet(jgpu.to_gpu(x))
    tnet(torch.from_numpy(x))
    assert _relL2(tnet[-2].data, jnet[-2].data) <= CHAIN_BOUND
    _close(tnet.data, jnet.data)

    got, want = attrsToNumpy(tnet), _jattrs(jnet)
    for stat in ("mean", "var"):
        names = sorted(name for name in want if name.endswith(stat))
        assert len(names) == 69
        assert _relL2(np.concatenate([got[n].ravel() for n in names]),
                      np.concatenate([want[n].ravel() for n in names])) <= CHAIN_BOUND


# (block function, its arguments but the four of act, bn, scheme; input maps, map)
V3_BLOCKS = {
    "bnBlock-v3": ("bnBlock", (192, [64], [48, 64], [64, 96, 96], [32], "mixed"), dict(b2size=5, b2pad=2, typ="v3"),
                   (192, 5)),
    "bnShrinkBlock-v3": ("bnShrinkBlock", (288, [384], [64, 96, 96], "mixed_3"), dict(b1deep=False, pad=0, typ="v3"),
                         (288, 7)),
    "factorBlock": ("factorBlock", (768, [192], [128, 128, 192], [128, 128, 128, 128, 192], [192], "mixed_4"), {},
                    (768, 4)),
    "v3ShrinkBlock": ("v3ShrinkBlock", (768, [192, 320], [192, 192, 192, 192], "mixed_8"), {}, (768, 7)),
    "expandBlock": ("expandBlock", (2048, [320], [384, 384, 384], [448, 384, 384, 384], [192], "mixed_10"),
                    dict(pool="max"), (2048, 3)),
}


@pytest.mark.parametrize("block", sorted(V3_BLOCKS))
def testInceptionV3BlockTwin(block):
    """Each block function of Inception-v3 at its width in the net, on a
    small map at batch 2 in train mode: the output, the input gradient,
    every variable's gradient and the running stats."""
    JInception, jgpu = _jax()
    blockFn, args, kwargs, (maps, side) = V3_BLOCKS[block]
    act, bn = False, False

    np.random.seed(1)
    jblock = getattr(JInception, blockFn)(*args, act, bn, "he", **kwargs)
    tblock = getattr(TInception, blockFn)(*args, act, bn, "none", **kwargs)
    _carry(jblock, tblock)

    x = np.random.RandomState(2).randn(2, maps, side, side).astype(np.float32)
    jout = jblock(jgpu.to_gpu(x))
    tout = tblock(torch.from_numpy(x))
    assert tuple(tout.shape) == tblock.dataShapeFrom(x.shape) == jblock.dataShapeFrom(x.shape)
    _close(tout, jout)

    grad = np.random.RandomState(3).randn(*tout.shape).astype(np.float32)
    jblock.backward(jgpu.to_gpu(grad))
    tblock.backward(torch.from_numpy(grad))
    _close(tblock.grad, jblock.grad)

    jgrads = {name: var.grad for var, names in jblock.getVarTable().items() for name in names}
    tgrads = {name: var.grad for var, names in tblock.getVarTable().items() for name in names}
    assert sorted(tgrads) == sorted(jgrads)
    for name, want in jgrads.items():
        _close(tgrads[name], want)

    got = attrsToNumpy(tblock)
    for name, ary in _jattrs(jblock).items():
        _close(got[name], ary)


def testExpandBlockInBf16AgainstTheReferencesF32():
    """``ToList`` takes bf16 in the port, so Inception-v3's ``expandBlock``
    runs in bf16 (the slice's type); the reference's ``ToList`` refuses it
    (ROADMAP Queue 3), so the bf16 block is held to the JAX package's f32
    block within 5e-2 of max(1, max |want|), the bf16 tier."""
    JInception, jgpu = _jax()
    import ml_dtypes
    from puzzlelib_tpu.modules import ModuleError as JModuleError
    from puzzlelib_tpu.modules import ToList as JToList

    with pytest.raises(JModuleError, match="Unsupported dtype"):
        JToList().calcMode(ml_dtypes.bfloat16)

    blockFn, args, kwargs, (maps, side) = V3_BLOCKS["expandBlock"]
    np.random.seed(1)
    jblock = JInception.expandBlock(*args, False, False, "he", **kwargs)
    tblock = TInception.expandBlock(*args, False, False, "none", **kwargs)
    _carry(jblock, tblock)
    tblock.evalMode()
    jblock.evalMode()
    tblock.calcMode(torch.bfloat16)

    x = np.random.RandomState(2).randn(2, maps, side, side).astype(np.float32)
    tout = tblock(torch.from_numpy(x).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    _close(tout, jblock(jgpu.to_gpu(x)), 5e-2)


def testInceptionSliceServes():
    """``inceptionslice.buildRun`` serves seeded images through the
    Calculator and the FusedCalculator (their SoftMax rows), the same
    numbers on both; the nets' K2 convs and fc1 shapes are the ones the
    slice names."""
    assert inceptionslice.data("bn", 3).shape == (3, 3, 224, 224)
    net = inceptionslice.build("bn", initscheme="none")
    assert resnetslice.winogradConvs(net, (32, 3, 224, 224)) == inceptionslice.KERNEL_CONVS[0][0].split()
    assert tuple(net["fc1"].W.shape) == inceptionslice.FC1["bn"][1:]
    assert tuple(inceptionslice.build("v3", initscheme="none")["fc1"].W.shape) == inceptionslice.FC1["v3"][1:]

    run = inceptionslice.buildRun("bn", dtype=torch.float32, batch=2)
    images = np.random.RandomState(4).randn(2, 3, 224, 224).astype(np.float32)

    out, _ = run.serve("hopper", images)
    fusedOut, _ = run.serve("fused", images)
    assert out.shape == (2, 1000) and np.allclose(out.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(fusedOut, out, rtol=F32_BOUND, atol=F32_BOUND)


@pytest.mark.cuda
def testInceptionBNServesThroughK1AndK2OnCard(monkeypatch):
    """Inception-BN in bf16 at batch 4 through ``Calculator``: one K1 (fc1)
    and two K2 launches a request, the logits within 5e-2 relative L2 of
    the library route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    monkeypatch.setattr(TConfig, "device", "cuda")
    monkeypatch.setattr(TConfig, "gemmAlgo", "hopper")
    monkeypatch.setattr(TConfig, "convAlgo", "hopper")
    run = inceptionslice.buildRun("bn", batch=4)
    images = inceptionslice.data("bn", 4)

    outs = {}
    for algo in ("torch", "hopper"):
        before = (matmul.launches, winograd.launches)
        outs[algo], _ = run.serve(algo, images)
        outs[algo + " launches"] = (matmul.launches - before[0], winograd.launches - before[1])

    assert outs["hopper launches"] == (1, 2) and outs["torch launches"] == (0, 0)
    assert np.linalg.norm(outs["hopper"] - outs["torch"]) / np.linalg.norm(outs["torch"]) <= 5e-2

"""The glue, upsampling and unpooling layers against the JAX package:
``DepthConcat``, ``Split``, ``Slice``, ``Tile``, ``Transpose``, ``MoveAxis``,
``Mul``, ``Glue``, ``Cast``, ``Pad2D``, ``PRelu``, ``Upsample2D`` /
``Upsample3D``, ``KMaxPool`` and ``MaxPool2D(useMask=True)`` with
``MaxUnpool2D``, each as a case of ``tools/layerslice.py``.

Each twin builds the JAX module and the port's from the same builder and
numpy seed, runs the forward and the backward on the same seeded inputs and
output gradient, and holds the output, the input gradient and every
parameter gradient: f32 within 1e-5 of max(1, max |want|), bf16 within
5e-2 of it (the reference's tiers).  Where the JAX module refuses bf16
(``calcMode``: DepthConcat, Slice, Glue, PRelu, the upsamplings, KMaxPool,
MaxUnpool2D; Pad2D's constant mode casts its output to f32 there), the
port's bf16 run is held to the JAX package's f32 run on the same bf16
values.  The cases cover overlapping unpool windows (3x3 stride 2), ties
(relu inputs, whose windows and lines are all 0), an odd extent (45 rows
pool to 22 and unpool to 45) and an inplace module after a ``Slice``.  The
card-only cases (``cuda`` marker) hold each case on CUDA tensors to its CPU
run."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.tools import layerslice

import layertwins as LT


BOUNDS = layerslice.BOUNDS

# the cases whose JAX module runs in bf16
JAX_BF16 = {"Split", "Tile", "Transpose", "MoveAxis", "Mul", "Pad2D reflect", "Cast"}

# the twins' shapes, the reference tests' where they have one, of this
# file's cases (the LRN, numeric and volume cases of ``layerslice`` have
# their twins in ``tests/test_torch_{lrn,numeric,volume}.py``)
SMALL = {
    "DepthConcat": [(2, 3, 5, 5), (2, 2, 3, 3), (2, 4, 4, 2)],
    "Split": [(64, 3, 5)], "Slice": [(2, 6, 5)], "Tile": [(2, 3, 4)], "Transpose": [(2, 3, 4)],
    "MoveAxis": [(2, 3, 4)], "Mul": [(3, 4)] * 3, "Glue": [(3, layerslice.GLUE_SIZE)], "Cast": [(2, 12, 5, 6)],
    "Pad2D reflect": [(2, 3, 5, 5)], "Pad2D constant": [(2, 3, 5, 5)],
    "PRelu": [(2, 64, 4, 4)], "PRelu shared": [(2, 64, 4, 4)],
    "Upsample2D nearest": [(2, 3, 4, 4)], "Upsample2D linear": [(2, 3, 5, 3)],
    "Upsample3D nearest": [(2, 3, 2, 3, 4)], "Upsample3D linear": [(2, 3, 2, 3, 4)],
    "MaxPool2D-MaxUnpool2D 2x2/2": [(2, 3, 8, 8)], "MaxPool2D-MaxUnpool2D 3x3/2": [(2, 3, 9, 9)],
    "KMaxPool": [(3, 4, 11)],
}


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


_jax, _host, _close = LT.jaxPackage, LT.host, LT.close


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("name", sorted(SMALL))
def testLayerTwin(name, dtype):
    """Each case forward and backward against the JAX package: the outputs,
    the input gradients and every parameter gradient (in bf16 against the
    JAX package's f32 run where it refuses bf16)."""
    LT.caseTwin(name, SMALL[name], dtype, jaxTakes=name in JAX_BF16)


def testPortTypesAndViews():
    """The port keeps the input's type (Pad2D's constant mode, where the
    reference casts to f32), and its Split, Slice, Transpose and MoveAxis
    outputs are no views of their input."""
    x = torch.randn(2, 6, 5, 7).to(torch.bfloat16)

    pad = T.Pad2D(1, fillValue=3.0)
    pad.calcMode(torch.bfloat16)
    assert pad(x).dtype == torch.bfloat16

    for mod in (T.Split(axis=1, sections=(2, 4)), T.Slice()[:, 1:-1], T.Transpose((0, 2, 3, 1)), T.MoveAxis(1, 3)):
        mod.calcMode(torch.bfloat16)
        out = mod(x)
        for part in out if isinstance(out, list) else [out]:
            assert part._base is None and part.data_ptr() != x.data_ptr()


# -- the indexed max pool and unpool ------------------------------------------------------------

def _poolUnpoolTwin(x, size, stride):
    """A ``MaxPool2D(useMask=True)`` and its ``MaxUnpool2D`` in a Sequential
    of each package, forward and backward, the outputs, the pooled maps and
    the input gradients held: (JAX net, port net, JAX output, port
    output)."""
    J, JC, jgpu, _ = _jax()
    jnet = layerslice._poolUnpool(J, JC, size, stride)
    tnet = layerslice._poolUnpool(T, TC, size, stride)

    jout, tout = jnet(jgpu.to_gpu(x)), tnet(torch.from_numpy(x))
    _close(tout, jout)
    _close(tnet[0].data, jnet.modules["pool"].data)

    grad = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    jnet.backward(jgpu.to_gpu(grad))
    tnet.backward(torch.from_numpy(grad))
    _close(tnet.grad, jnet.grad)
    return jnet, tnet, jout, tout


def testMaskedPoolOddExtent():
    """45 rows pool to 22 and unpool to 45, 31 columns to 15 and 31: the
    forward restores the pool's input extent in both packages, while
    ``dataShapeFrom`` answers the reference's (n - 1) * stride + size: 44
    rows and 30 columns, the same in both."""
    x = np.maximum(np.random.RandomState(4).randn(1, 2, 45, 31), 0).astype(np.float32)
    jnet, tnet, _, tout = _poolUnpoolTwin(x, 2, 2)

    assert tout.shape == (1, 2, 45, 31) and tuple(tnet[0].data.shape) == (1, 2, 22, 15)
    assert tnet.dataShapeFrom((1, 2, 45, 31)) == jnet.dataShapeFrom((1, 2, 45, 31)) == (1, 2, 44, 30)
    assert tnet[1].gradShapeFrom((1, 2, 45, 31)) == jnet.modules["unpool"].gradShapeFrom((1, 2, 45, 31))


def testMaskedPoolTiesGoToTheFirstCell():
    """All-zero windows (a relu's output) send their gradient to the window's
    first cell in window order, in both packages, and so does the unpool."""
    x = np.zeros((1, 1, 4, 6), np.float32)
    x[0, 0, 0, 1] = x[0, 0, 1, 0] = 2.0   # the first window holds two equal maxima
    _, tnet, _, tout = _poolUnpoolTwin(x, 2, 2)

    want = np.zeros_like(x)
    want[0, 0, 0, 1] = 2.0
    assert np.array_equal(_host(tout), want)


def testOverlappingWindowsAdd():
    """3x3 windows of stride 2 overlap; where two windows take their maximum
    from the same cell, the unpool adds both, as the reference's scatter
    does (``F.max_unpool2d`` would keep one)."""
    x = np.zeros((1, 1, 5, 5), np.float32)
    x[0, 0, 2, 2] = 5.0   # the maximum of all four windows
    _, tnet, jout, tout = _poolUnpoolTwin(x, 3, 2)

    assert _host(tout)[0, 0, 2, 2] == 20.0 and np.count_nonzero(_host(tout)) == 1
    assert np.array_equal(_host(tout), _host(jout))


def testMaxUnpoolHoldsItsPoolOutsideItsChildren():
    """The unpool turns its pool's mask on and holds the pool as a plain
    attribute: the net lists each module once."""
    net = layerslice._poolUnpool(T, TC, 2, 2)
    pool, unpool = net[0], net[1]

    assert pool.useMask and not pool.gradUsesOutData and unpool.maxpool2d is pool
    assert list(unpool.children()) == [] and len(list(net.modules())) == 3

    net(torch.randn(1, 2, 6, 6))
    with pytest.raises(T.ModuleError):
        unpool(torch.randn(1, 2, 2, 2))


def testKMaxPoolTiesKeepTheReferencesOrder():
    """Equal values come out lower index first before the reversal, as
    ``lax.top_k`` orders them: the gradient of a line of zeros lands on its
    first k cells, in the JAX package's order."""
    J, _, jgpu, _ = _jax()
    x = np.zeros((2, 7, 3), np.float32)
    x[1, 5, 0] = 1.0
    grad = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3) + 1

    jmod, tmod = J.KMaxPool(topk=3, axis=1), T.KMaxPool(topk=3, axis=1)
    _close(tmod(torch.from_numpy(x)), jmod(jgpu.to_gpu(x)))
    jmod.backward(jgpu.to_gpu(grad))
    tmod.backward(torch.from_numpy(grad))

    assert np.array_equal(_host(tmod.grad), _host(jmod.grad))
    assert np.array_equal(_host(tmod.indices)[0, :, 0], [2, 1, 0])


# -- inplace after a view, Cast and Glue --------------------------------------------------------

@pytest.mark.parametrize("module", ["Activation", "PRelu"])
def testInplaceModuleAfterSlice(module):
    """An inplace module after a ``Slice`` writes the slice's copy, not the
    input: the input is left as it was, and the outputs (and the
    activation's gradient) are the JAX package's."""
    J, JC, jgpu, _ = _jax()
    x = np.random.RandomState(5).randn(2, 6, 4, 5).astype(np.float32)

    def build(M, C):
        net = C.Sequential()
        net.append(M.Slice()[:, 1:-1])
        net.append(M.Activation(M.sigmoid, inplace=True) if module == "Activation" else
                   M.PRelu(4, inplace=True))
        return net

    jnet, tnet = build(J, JC), build(T, TC)
    tin = torch.from_numpy(x.copy())

    _close(tnet(tin), jnet(jgpu.to_gpu(x)))
    assert np.array_equal(tin.numpy(), x)
    assert tnet[1].data.data_ptr() == tnet[0].data.data_ptr()

    if module == "Activation":
        grad = np.random.RandomState(6).randn(2, 4, 4, 5).astype(np.float32)
        jnet.backward(jgpu.to_gpu(grad))
        tnet.backward(torch.from_numpy(grad))
        _close(tnet.grad, jnet.grad)
    else:
        with pytest.raises(T.ModuleError):
            tnet.backward(torch.zeros(2, 4, 4, 5))


def testCastChecksTypes():
    """A Cast refuses an input of another type than its intype and a
    gradient of another than its outtype, as the reference's does; equal
    types pass the tensor through."""
    cast = T.Cast("float32", "bfloat16")
    with pytest.raises(T.ModuleError):
        cast(torch.zeros(2, 3, dtype=torch.bfloat16))

    out = cast(torch.ones(2, 3))
    assert out.dtype == torch.bfloat16
    with pytest.raises(T.ModuleError):
        cast.backward(torch.ones(2, 3))

    same = T.Cast(np.float32, torch.float32)
    x = torch.ones(2, 3)
    assert same(x) is x
    assert T.Cast.dataTypeToNumpy(torch.bfloat16) == T.DataType.bfloat16


def testGlueShapeHooks():
    """The shape hooks answer the shape queries; a missing one raises, as in
    the reference; the inner modules are no children of the Glue."""
    glue = layerslice._glue(T)
    assert glue.dataShapeFrom((3, 5)) == (3, 5) and list(glue.children()) == []

    bare = T.Glue(fwdGlue=lambda d, m: d, bwdGlue=lambda g, m: g)
    with pytest.raises(T.ModuleError):
        bare.dataShapeFrom((3, 5))
    with pytest.raises(T.ModuleError):
        bare.gradShapeFrom((3, 5))
    with pytest.raises(T.ModuleError):
        T.Glue(modules=[T.Identity()])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def testLayerOnCard(monkeypatch, name):
    """Each case on CUDA tensors against its CPU run, f32 and bf16: bit for
    bit where it only moves data, within the tiers otherwise; and a second
    card run the same bits."""
    LT.cardAgainstCpu(name, SMALL[name])

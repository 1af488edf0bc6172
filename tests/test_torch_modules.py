"""Forward twins of the port's modules against the JAX package's.

Each twin builds the JAX module and the port's from the same numpy seed
(the port keeps the reference's numpy weight sampler), gives both the same
numpy input, and compares the outputs.  Also covered: ``calcMode`` casting,
the ``nn.Module`` protocol, and the parameter tables of ``convert``.
"""

import numpy as np
import pytest
import torch

# every test here is a twin: skip where the JAX package does not import, as
# on the card's machine
pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")

import ml_dtypes  # noqa: E402

from puzzlelib_tpu.backend import gpuarray as jgpu  # noqa: E402
from puzzlelib_tpu import modules as J  # noqa: E402
from puzzlelib_tpu import containers as JC  # noqa: E402

from puzzlelib_tpu_torch import modules as T  # noqa: E402
from puzzlelib_tpu_torch import containers as TC  # noqa: E402
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy  # noqa: E402


F32_BOUND = 1e-5   # the reference's f32 tier (tensor.py dtypesSupported)
BF16_BOUND = 5e-2  # its bf16 tier


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The twins compare on the CPU, also on a machine with a card."""
    from puzzlelib_tpu_torch import config as Config

    monkeypatch.setattr(Config, "device", "cpu")


def _twins(factory, seed=0):
    """(JAX module, port module) built from one numpy seed each."""
    np.random.seed(seed)
    jmod = factory(J)
    np.random.seed(seed)
    tmod = factory(T)
    return jmod, tmod


def _jaxTable(jmod):
    """Variable name -> array; an unnamed leaf module names its own as "W", "b"."""
    return {name: var.data.get() for var, names in jmod.getVarTable().items() for name in names}


def _randomizeBiases(jmod, tmod, seed):
    """Non-zero biases in both twins, through the JAX net's table."""
    rng = np.random.RandomState(seed)
    table = _jaxTable(jmod)

    for name in table:
        if name.endswith("b"):
            table[name] = rng.randn(*table[name].shape).astype(table[name].dtype)
            jmod.getVar(name).data.set(table[name])

    paramsFromNumpy(tmod, table)


def _compare(jmod, tmod, x, bound=F32_BOUND):
    want = np.asarray(jmod(jgpu.to_gpu(x)).get(), dtype=np.float32)
    got = tmod(torch.from_numpy(x)).float().numpy()

    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("inmaps, outmaps, size, stride, pad, dilation, hw",
                         [(3, 8, 3, 1, 1, 1, (9, 7)), (4, 6, 3, 2, 0, 1, (11, 10)), (2, 5, 5, 1, 2, 2, (12, 12)),
                          (8, 4, 1, 1, 0, 1, (5, 6))])
def testConv2DTwin(inmaps, outmaps, size, stride, pad, dilation, hw):
    jmod, tmod = _twins(lambda M: M.Conv2D(inmaps, outmaps, size, stride=stride, pad=pad, dilation=dilation,
                                           initscheme="he"))
    assert np.array_equal(tmod.W.numpy(), jmod.W.get())

    _randomizeBiases(jmod, tmod, 1)
    x = np.random.RandomState(2).randn(2, inmaps, *hw).astype(np.float32)

    _compare(jmod, tmod, x)
    assert tmod.dataShapeFrom(x.shape) == jmod.dataShapeFrom(x.shape) == tuple(tmod.data.shape)


@pytest.mark.parametrize("transpose", [False, True])
def testLinearTwin(transpose):
    # the reference's transposed Linear gives its bias the input width, which
    # cannot broadcast onto the output: it is only usable without a bias
    jmod, tmod = _twins(lambda M: M.Linear(12, 7, initscheme="xavier", transpose=transpose, useBias=not transpose))
    assert np.array_equal(tmod.W.numpy(), jmod.W.get())

    _randomizeBiases(jmod, tmod, 3)
    x = np.random.RandomState(4).randn(5, 12).astype(np.float32)

    _compare(jmod, tmod, x)


@pytest.mark.parametrize("size, stride, pad", [(2, 2, 0), (3, 2, 1), (3, 1, 1)])
def testMaxPool2DTwin(size, stride, pad):
    jmod, tmod = _twins(lambda M: M.MaxPool2D(size, stride, pad))
    x = np.random.RandomState(5).randn(2, 3, 9, 8).astype(np.float32)

    _compare(jmod, tmod, x)


def testReluTwin():
    jmod, tmod = _twins(lambda M: M.Activation(M.relu))
    x = np.random.RandomState(6).randn(3, 4, 5).astype(np.float32)

    _compare(jmod, tmod, x)


def testReluInplace():
    mod = T.Activation(T.relu, inplace=True)
    x = torch.from_numpy(np.random.RandomState(7).randn(4, 6).astype(np.float32))

    assert mod(x) is x and (x >= 0).all()


def testFlattenTwin():
    jmod, tmod = _twins(lambda M: M.Flatten())
    x = np.random.RandomState(8).randn(3, 4, 5, 2).astype(np.float32)

    _compare(jmod, tmod, x)
    assert tmod.dataShapeFrom(x.shape) == jmod.dataShapeFrom(x.shape)

    # a channels-last input flattens in logical NCHW order
    cl = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    assert np.array_equal(tmod(cl).numpy(), x.reshape(3, -1))


@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 3, 4)])
def testSoftMaxTwin(shape):
    jmod, tmod = _twins(lambda M: M.SoftMax())
    x = (np.random.RandomState(9).randn(*shape) * 3).astype(np.float32)

    _compare(jmod, tmod, x)


@pytest.mark.parametrize("factory, shape", [
    (lambda M: M.Conv2D(4, 6, 3, pad=1, initscheme="he"), (2, 4, 7, 6)),
    (lambda M: M.Linear(16, 8, initscheme="he"), (4, 16)),
])
def testCalcModeBf16Twin(factory, shape):
    """calcMode(bf16) recreates the vars in bf16 (registered parameters
    included), the module then takes and gives bf16, and it agrees with the
    JAX module in bf16 at the reference's bf16 tier."""
    jmod, tmod = _twins(factory)
    _randomizeBiases(jmod, tmod, 10)

    w32 = tmod.W.detach().clone()
    jmod.calcMode(ml_dtypes.bfloat16)
    tmod.calcMode(torch.bfloat16)

    assert tmod.calctype == torch.bfloat16
    assert all(var.data.dtype == torch.bfloat16 for var in tmod.vars.values())
    assert all(p.dtype == torch.bfloat16 for p in tmod.parameters())
    assert tmod.W is tmod.vars["W"].data
    assert torch.equal(tmod.W, w32.to(torch.bfloat16))

    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = np.asarray(jmod(jgpu.to_gpu(x.astype(ml_dtypes.bfloat16))).get(), dtype=np.float32)
    out = tmod(torch.from_numpy(x).to(torch.bfloat16))

    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - want).max() <= BF16_BOUND * max(1.0, np.abs(want).max())

    with pytest.raises(T.ModuleError):
        tmod(torch.from_numpy(x))    # f32 data into a bf16 module


def _jaxNet():
    net = JC.Sequential(name="net")
    net.append(J.Conv2D(3, 4, 3, pad=1, initscheme="he", name="c1"))
    net.append(J.Activation(J.relu, name="r1"))
    net.append(J.Flatten())
    net.append(J.Linear(4 * 5 * 5, 6, initscheme="he", name="fc"))
    return net


def _torchNet():
    net = TC.Sequential(name="net")
    net.append(T.Conv2D(3, 4, 3, pad=1, initscheme="none", name="c1"))
    net.append(T.Activation(T.relu, name="r1"))
    net.append(T.Flatten())
    net.append(T.Linear(4 * 5 * 5, 6, initscheme="none", name="fc"))
    return net


def testParamsRoundTrip():
    np.random.seed(12)
    table = _jaxTable(_jaxNet())
    assert sorted(table) == ["c1.W", "c1.b", "fc.W", "fc.b"]

    net = _torchNet()
    paramsFromNumpy(net, table)
    back = paramsToNumpy(net)

    assert sorted(back) == sorted(table)
    for name in table:
        assert back[name].dtype == np.float32 and np.array_equal(back[name], table[name])

    # bf16 tables (ml_dtypes, as a bf16 JAX net gives them) load through f32
    net.calcMode(torch.bfloat16)
    paramsFromNumpy(net, {name: ary.astype(ml_dtypes.bfloat16) for name, ary in table.items()})
    for name, ary in paramsToNumpy(net).items():
        assert np.array_equal(ary, table[name].astype(ml_dtypes.bfloat16).astype(np.float32))


def testParamsFromNumpyRejectsMismatches():
    np.random.seed(13)
    table = _jaxTable(_jaxNet())
    net = _torchNet()

    with pytest.raises(KeyError):
        paramsFromNumpy(net, {k: v for k, v in table.items() if k != "fc.b"})

    with pytest.raises(KeyError):
        paramsFromNumpy(net, dict(table, extra=np.zeros(1, np.float32)))

    with pytest.raises(ValueError):
        paramsFromNumpy(net, dict(table, **{"fc.b": np.zeros(7, np.float32)}))


def testNnModuleProtocol():
    """The clashes with nn.Module are handled: ``train()`` and ``modules()``
    stay methods, the PuzzleLib flag is ``training``, children are
    registered, and parameters are the variables' tensors."""
    net = _torchNet()

    assert net["c1"] is net.c1 and net[0] is net["c1"]
    assert [m.name for m in net.graph] == ["c1", "r1", "2", "fc"]
    assert sum(1 for _ in net.modules()) == 5
    assert dict(net.named_parameters()).keys() == {"c1.W", "c1.b", "fc.W", "fc.b"}
    assert net.getVar("fc.W").data is net["fc"].W
    assert net.numOfParams() == 4 * 3 * 9 + 4 + 100 * 6 + 6

    net.evalMode()
    assert not net.training and not net["c1"].training

    net.trainMode()
    assert net.training and net["fc"].training

    net.train(False)
    assert not net["fc"].training

    x = torch.zeros(2, 3, 5, 5)
    assert tuple(net.forward(x).shape) == (2, 6)

    with pytest.raises(T.ModuleError):
        net(torch.zeros(2, 4, 5, 5))


_PRECISION_FLAGS = [(torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"),
                    (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction"),
                    (torch.backends.cuda.matmul, "allow_fp16_reduced_precision_reduction")]


def testPrecisionConfigSetsTf32Flags(monkeypatch):
    """TF32 and reduced-precision reductions are off exactly while
    ``matmulPrecision`` is "highest"."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend import device

    for owner, flag in _PRECISION_FLAGS:
        monkeypatch.setattr(owner, flag, getattr(owner, flag))

    monkeypatch.setattr(Config, "matmulPrecision", "high")
    device.ensureInit()
    assert all(getattr(owner, flag) for owner, flag in _PRECISION_FLAGS)

    monkeypatch.setattr(Config, "matmulPrecision", "highest")
    device.ensureInit()
    assert not any(getattr(owner, flag) for owner, flag in _PRECISION_FLAGS)


def testUnknownAlgoIsRejected(monkeypatch):
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend import blas

    monkeypatch.setattr(Config, "gemmAlgo", "pallas")
    a = torch.zeros(2, 2)

    with pytest.raises(Config.ConfigError):
        Config.route(Config.gemmAlgo)

    # a CPU product never asks: only CUDA tensors reach the kernel dispatch
    assert blas.mulMatrixOnMatrix(a, a).shape == (2, 2)

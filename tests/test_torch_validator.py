"""The validation half of the port against the JAX package's: ``Validator``
(``validateFromHost`` and ``validate``), ``Cost.validate`` and
``CrossEntropy``'s validation error and per-class weights.

The Validator twins hold the port to the JAX package's error exactly: the
port sums each batch's f32 error, weighted by the batch's size, in f64 on
the device, in the reference's order."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import handlers as TH
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy
from puzzlelib_tpu_torch.cost import CostError, CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.models.nets import loadLeNet as tLoadLeNet

from test_torch_slice import _narrowVGG


F32_BOUND = 1e-5   # the reference's f32 tier (tensor.py dtypesSupported)
BF16_BOUND = 5e-2  # its bf16 tier


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, handlers, modules
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, handlers, cost, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _table(jnet):
    return {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}


def _twinNets(kind):
    """(JAX net, port net) with the JAX net's weights, and the images' shape."""
    J, JC, _, _, _ = _jax()
    np.random.seed(0)

    if kind == "vgg":
        jnet, tnet, shape = _narrowVGG(J, JC, "he"), _narrowVGG(T, TC, "none"), (3, 16, 16)
    else:
        from puzzlelib_tpu.models.nets.lenet import loadLeNet

        jnet, tnet, shape = loadLeNet(None, initscheme=None), tLoadLeNet(None), (1, 28, 28)

    paramsFromNumpy(tnet, _table(jnet))
    return jnet, tnet, shape


def _data(shape, n, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, *shape).astype(np.float32), rng.randint(0, 10, size=n).astype(np.int32)


@pytest.mark.parametrize("kind", ["vgg", "lenet"])
@pytest.mark.parametrize("n, batch, macro", [(10, 4, 6), (23, 8, 10000)])
def testValidateFromHostTwin(kind, n, batch, macro):
    """``validateFromHost`` over macro-batches and a partial last batch
    returns the JAX package's error, to the bit (f32 data, f32 nets)."""
    _, _, JH, JCost, _ = _jax()
    jnet, tnet, shape = _twinNets(kind)
    x, y = _data(shape, n)

    want = JH.Validator(jnet, JCost.CrossEntropy(maxlabels=10), batchsize=batch).validateFromHost(
        x, y, macroBatchSize=macro)
    validator = TH.Validator(tnet, TCrossEntropy(maxlabels=10), batchsize=batch)
    got = validator.validateFromHost(x, y, macroBatchSize=macro)

    assert isinstance(got, float) and got == want == validator.error
    assert 0.0 < got < 1.0


def testValidateOnDeviceDataTwin():
    """``validate`` of data already on the device: the JAX package's error,
    and the net left in eval mode."""
    _, _, JH, JCost, jgpu = _jax()
    jnet, tnet, shape = _twinNets("lenet")
    x, y = _data(shape, 14, seed=2)

    want = JH.Validator(jnet, JCost.CrossEntropy(), batchsize=4).validate(jgpu.to_gpu(x), jgpu.to_gpu(y))
    tnet.trainMode()
    got = TH.Validator(tnet, TCrossEntropy(), batchsize=4).validate(torch.from_numpy(x), torch.from_numpy(y))

    assert got == want
    assert not tnet.training and not any(mod.training for mod in tnet.graph)


def testValidatorReadsTheErrorBackOnce(monkeypatch):
    """The batches' errors stay on the device: one ``item`` a call, however
    many batches."""
    _, tnet, shape = _twinNets("lenet")
    x, y = _data(shape, 20)

    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: reads.append(1) or item(self))
    TH.Validator(tnet, TCrossEntropy(), batchsize=4).validateFromHost(x, y)

    assert len(reads) == 1


def _scores(shape, dtype, seed=3):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(*shape) * 2).astype(np.float32)
    labels = rng.randint(0, shape[1], size=(shape[0], ) + shape[2:]).astype(np.int32)
    return scores, labels


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(6, 10), (3, 7, 2, 3)])
def testCrossEntropyTwin(shape, weighted, dtype):
    """Gradient, error and validation error with and without per-class
    weights: f32 within 1e-5, bf16 at the reference's tier; the validation
    error and the argmax predictions exactly."""
    import ml_dtypes

    _, _, _, JCost, jgpu = _jax()
    scores, labels = _scores(shape, dtype)
    weights = np.random.RandomState(4).uniform(0.2, 2.0, size=shape[1]).astype(np.float32) if weighted else None
    jtype, ttype = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}[dtype]
    bound = F32_BOUND if dtype == "f32" else BF16_BOUND

    jcost, tcost = JCost.CrossEntropy(weights=weights), TCrossEntropy(weights=weights)
    jscores, tscores = jgpu.to_gpu(scores.astype(jtype)), torch.from_numpy(scores).to(ttype)

    jerr, jgrad = jcost(jscores, jgpu.to_gpu(labels))
    terr, tgrad = tcost(tscores, torch.from_numpy(labels))

    assert abs(terr - jerr) <= bound * max(1.0, abs(jerr))
    want = np.asarray(jgrad.get(), dtype=np.float32)
    assert np.abs(tgrad.float().numpy() - want).max() <= bound * max(1.0, np.abs(want).max())

    jval = jcost.validate(jscores, jgpu.to_gpu(labels))
    tval = tcost.validate(tscores, torch.from_numpy(labels))
    assert isinstance(tval, float) and tval == jval == tcost.getValError()
    assert np.array_equal(tcost.mostProb.numpy(), np.asarray(jcost.mostProb.get()))


def testWeightsScaleTheErrorAndGradient():
    """All weights 2: twice the unweighted error and gradient."""
    scores, labels = _scores((5, 4), "f32")
    plain, doubled = TCrossEntropy(), TCrossEntropy(weights=np.full(4, 2.0, np.float32))

    err, grad = plain(torch.from_numpy(scores), torch.from_numpy(labels))
    err2, grad2 = doubled(torch.from_numpy(scores), torch.from_numpy(labels))

    assert err2 == pytest.approx(2 * err, rel=1e-6)
    assert torch.allclose(grad2, 2 * grad)


def testCrossEntropyRejectsWeightsOfAnotherWidth():
    scores, labels = _scores((5, 4), "f32")
    with pytest.raises(CostError, match="weights"):
        TCrossEntropy(weights=np.ones(3, np.float32))(torch.from_numpy(scores), torch.from_numpy(labels))


def testValidationVerifiesLabels(monkeypatch):
    """With ``Config.verifyData`` a label out of range fails the validation,
    in ``validate`` and in the Validator's device path."""
    scores, labels = _scores((5, 4), "f32")
    labels[2] = 4
    monkeypatch.setattr(TConfig, "verifyData", True)

    with pytest.raises(CostError, match="> 3"):
        TCrossEntropy().validate(torch.from_numpy(scores), torch.from_numpy(labels))

    with pytest.raises(CostError, match="> 3"):
        TCrossEntropy().validateDev(torch.from_numpy(scores), torch.from_numpy(labels))


def testResetClearsTheValidationError():
    scores, labels = _scores((5, 4), "f32")
    cost = TCrossEntropy()
    cost.validate(torch.from_numpy(scores), torch.from_numpy(labels))
    assert cost.getValError() is not None and cost.mostProb is not None

    cost.reset()
    assert cost.getValError() is None and cost.mostProb is None

    cost.accumErr.fill_(3.0)
    cost.resetDeviceAccumulator()
    assert cost.accumErr.item() == 0.0

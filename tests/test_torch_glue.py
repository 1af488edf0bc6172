"""The glue of the U-Net and Inception slices against the JAX package: the
six activations beside relu (with ``slc`` and ``args``, in place and out of
place), ``Concat``, ``ToList``, the containers' ``getByName`` /
``getAllByType`` and the ``BCE`` cost.

Each twin builds the JAX object and the port's from one numpy seed; f32 is
held within 1e-5 of max(1, max |want|), bf16 within 5e-2 of it (the
reference's tiers).  The card-only cases (``cuda`` marker) hold the
activations on CUDA tensors to their CPU results."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.cost import BCE as TBCE
from puzzlelib_tpu_torch.cost import CostError
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.ops import cost as costOps


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}
OTHERS = ["sigmoid", "tanh", "leakyRelu", "elu", "softPlus", "clip"]


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, cost, modules
    from puzzlelib_tpu.backend import gpuarray

    types = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
    return modules, containers, cost, gpuarray, types


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=BOUNDS["f32"]):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _twin(jmod, tmod, inputs, dtype="f32", seed=9):
    """Forward ``inputs`` (an array or a nested list of arrays) and backward
    a seeded output gradient through both modules: (JAX output, port
    output, JAX input gradient, port input gradient, the port's input)."""
    _, _, _, jgpu, types = _jax()
    jtype, ttype = types[dtype]
    if dtype != "f32":
        jmod.calcMode(jtype)
        tmod.calcMode(ttype)

    def each(fn, tree):
        return [each(fn, node) for node in tree] if isinstance(tree, list) else fn(tree)

    tin = each(lambda ary: torch.from_numpy(ary).to(ttype), inputs)
    jout = jmod(each(lambda ary: jgpu.to_gpu(ary.astype(jtype)), inputs))
    tout = tmod(tin)

    rng = np.random.RandomState(seed)
    grads = each(lambda out: rng.randn(*out.shape).astype(np.float32), jout if isinstance(jout, list) else jout)
    jmod.backward(each(lambda ary: jgpu.to_gpu(ary.astype(jtype)), grads))
    tmod.backward(each(lambda ary: torch.from_numpy(ary).to(ttype), grads))
    return jout, tout, jmod.grad, tmod.grad, tin


# -- activations ---------------------------------------------------------------------------------

def _activationTwin(name, dtype="f32", inplace=False, slc=None, args=()):
    J = _jax()[0]
    x = np.random.RandomState(1).randn(2, 3, 7, 9).astype(np.float32) * 3

    jmod = J.Activation(getattr(J, name), slc=slc, inplace=inplace, args=args)
    tmod = T.Activation(getattr(T, name), slc=slc, inplace=inplace, args=args)

    jout, tout, jgrad, tgrad, tin = _twin(jmod, tmod, x, dtype)
    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])
    return tout, tin


@pytest.mark.parametrize("slc", [None, slice(5, 300)])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("name", OTHERS)
def testActivationTwin(name, inplace, slc):
    """Each of the six, forward and backward (its derivative from the
    output), out of place and in place (the output written over the input),
    over the whole tensor and over a flat slice with the rest passed
    through."""
    tout, tin = _activationTwin(name, inplace=inplace, slc=slc)
    assert (tout.data_ptr() == tin.data_ptr()) == inplace


@pytest.mark.parametrize("name, args", [("leakyRelu", (0.2, )), ("elu", (0.5, )), ("clip", (-1.0, 2.5))])
def testActivationArgsTwin(name, args):
    """leakyRelu, elu and clip with arguments other than their defaults."""
    _activationTwin(name, args=args)
    _activationTwin(name, args=args, slc=slice(10, 200))


@pytest.mark.parametrize("name", OTHERS)
def testActivationBf16Twin(name):
    _activationTwin(name, dtype="bf16")


def testActivationDefaultsAreTheReferences():
    J = _jax()[0]
    for name in OTHERS + ["relu"]:
        assert T.Activation(getattr(T, name)).actArgs == J.Activation(getattr(J, name)).actArgs

    with pytest.raises(ValueError):
        T.Activation("swish")


@pytest.mark.parametrize("module", ["Activation", "Dropout"])
def testInplaceModuleWritesThroughNoView(module):
    """An inplace activation or dropout writes its gradient over the
    incoming one, but not over a view of another tensor (a ``Concat``
    backward's split): that tensor is left as it was."""
    mod = T.Activation(T.sigmoid, inplace=True) if module == "Activation" else T.Dropout(inplace=True)
    x = torch.randn(2, 6, 4, 4)
    mod(x)

    whole = torch.randn(2, 6, 4, 4)
    mod.backward(whole)
    assert mod.grad.data_ptr() == whole.data_ptr()

    mod(torch.randn(2, 3, 4, 4))
    base = torch.randn(2, 6, 4, 4)
    kept = base.clone()
    view = torch.split(base, [3, 3], dim=1)[0]
    mod.backward(view)
    assert torch.equal(base, kept) and mod.grad.data_ptr() != view.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("name", OTHERS + ["relu"])
def testActivationOnCard(monkeypatch, name):
    """On CUDA tensors each activation gives its CPU result (bf16 and f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(2)).to(dtype) * 3
        grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
        results = []
        for device in ("cpu", "cuda"):
            monkeypatch.setattr(TConfig, "device", device)
            mod = T.Activation(getattr(T, name), slc=slice(3, 2000))
            mod.calcMode(dtype)
            out = mod(x.to(device))
            mod.backward(grad.to(device))
            results.append((out.float().cpu(), mod.grad.float().cpu()))

        (cpuOut, cpuGrad), (cudaOut, cudaGrad) = results
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert torch.allclose(cudaOut, cpuOut, atol=tol, rtol=tol)
        assert torch.allclose(cudaGrad, cpuGrad, atol=tol, rtol=tol)


# -- Concat and ToList ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("axis", [1, 2])
def testConcatTwin(axis, dtype):
    """Three inputs along the maps and along the rows: the output, and the
    gradient split back into the three inputs' sections."""
    J = _jax()[0]
    rng = np.random.RandomState(2)
    shapes = [(2, 3, 5, 4), (2, 4, 5, 4), (2, 2, 5, 4)] if axis == 1 else [(2, 3, 2, 4), (2, 3, 5, 4),
                                                                             (2, 3, 1, 4)]
    xs = [rng.randn(*shape).astype(np.float32) for shape in shapes]

    jmod, tmod = J.Concat(axis), T.Concat(axis)
    assert tmod.dataShapeFrom(shapes) == jmod.dataShapeFrom(shapes)

    jout, tout, jgrads, tgrads, _ = _twin(jmod, tmod, xs, dtype)
    _close(tout, jout, BOUNDS[dtype])
    assert len(tgrads) == 3
    for tgrad, jgrad, shape in zip(tgrads, jgrads, shapes):
        assert tuple(tgrad.shape) == shape
        _close(tgrad, jgrad, BOUNDS[dtype])

    assert tmod.gradShapeFrom(tuple(tout.shape)) == jmod.gradShapeFrom(tuple(jout.shape))


def testConcatRefusesInconsistentShapes():
    with pytest.raises(T.ModuleError, match="inconsistent"):
        T.Concat(1)([torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 5, 4)])

    mod = T.Concat(1)
    mod([torch.zeros(2, 3, 4, 4), torch.zeros(2, 1, 4, 4)])
    with pytest.raises(T.ModuleError, match="grad shape"):
        mod.backward(torch.zeros(2, 3, 4, 4))


def testToListTwin():
    """A nested list flattened depth first, and the flat gradient nested
    back as the input was."""
    J = _jax()[0]
    rng = np.random.RandomState(3)
    shapes = [[(2, 3), [(2, 4), (2, 5)]], (2, 6), [[(2, 7)]]]

    def make(tree):
        return [make(node) for node in tree] if isinstance(tree, list) else rng.randn(*tree).astype(np.float32)

    xs = make(shapes)
    jmod, tmod = J.ToList(), T.ToList()
    assert tmod.dataShapeFrom(shapes) == jmod.dataShapeFrom(shapes) == [(2, 3), (2, 4), (2, 5), (2, 6), (2, 7)]

    jout, tout, jgrad, tgrad, tin = _twin(jmod, tmod, xs)
    assert [t.data_ptr() for t in tout] == [tin[0][0].data_ptr(), tin[0][1][0].data_ptr(),
                                            tin[0][1][1].data_ptr(), tin[1].data_ptr(), tin[2][0][0].data_ptr()]
    for got, want in zip(tout, jout):
        _close(got, want)

    def pairs(got, want):
        if isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want)
            for g, w in zip(got, want):
                pairs(g, w)
        else:
            _close(got, want)

    pairs(tgrad, jgrad)
    assert tmod.gradShapeFrom([tuple(t.shape) for t in tout]) == [[(2, 3), [(2, 4), (2, 5)]], (2, 6), [[(2, 7)]]]


# -- container lookups ---------------------------------------------------------------------------

def testLookupsOnUNetTwin(monkeypatch):
    """``getByName`` and ``getAllByType`` on U-Net find the same modules, by
    name and in the same order, in both packages, down the nested blocks."""
    J, _, _, _, _ = _jax()
    from puzzlelib_tpu import config as JConfig
    from puzzlelib_tpu.models.nets import loadUNet as jLoadUNet

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    jnet, tnet = jLoadUNet(None, initscheme="none"), TNets.loadUNet(None, initscheme="none")

    for name in ("block_2", "conv_1_1", "conv_5_2", "upscore1", "drop4", "concat4", "fork_3", "score"):
        jmod, tmod = jnet.getByName(name), tnet.getByName(name)
        assert tmod is not None and tmod.name == jmod.name == name and type(tmod).__name__ == type(jmod).__name__

    assert tnet.getByName("conv_10_1") is None and jnet.getByName("conv_10_1") is None

    for jtype, ttype, count in ((J.Dropout, T.Dropout, 2), (J.Deconv2D, T.Deconv2D, 4), (J.Concat, T.Concat, 4),
                                (J.Conv2D, T.Conv2D, 22), (J.Identity, T.Identity, 4)):
        found = [mod.name for mod in tnet.getAllByType(ttype)]
        assert found == [mod.name for mod in jnet.getAllByType(jtype)] and len(found) == count

    # a container that matches is not searched further: the Sequentials
    # under the top's fork_1 only
    from puzzlelib_tpu.containers import Sequential as JSequential
    from puzzlelib_tpu_torch.containers import Sequential
    found = [mod.name for mod in tnet.getAllByType(Sequential)]
    assert found == [mod.name for mod in jnet.getAllByType(JSequential)] == ["block_2", "shortcut_2"]


# -- BCE --------------------------------------------------------------------------------------------

def _bceData(shape, seed=4):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(*shape) * 3).astype(np.float32)
    labels = rng.randint(0, 2, size=(shape[0], ) if shape[1:] == (1, ) else (shape[0], ) + shape[2:])
    return scores, labels.astype(np.int32)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("shape", [(16, 1), (3, 1, 8, 6)])
def testBCETwin(shape, dtype):
    """The error, the gradient and the validation error (the share of wrong
    signs) against the JAX package's ``BCE`` and ``ops.cost.bce``, on
    (N, 1) scores with (N, ) labels and on (N, 1, H, W) scores with (N, H,
    W) labels."""
    _, _, JCost, jgpu, types = _jax()
    from puzzlelib_tpu.ops import cost as jcostOps

    jtype, ttype = types[dtype]
    scores, labels = _bceData(shape)
    scores[0, 0] = 0.0   # a zero logit is wrong for label 1, right for 0

    jscores, jlabels = jgpu.to_gpu(scores.astype(jtype)), jgpu.to_gpu(labels)
    tscores, tlabels = torch.from_numpy(scores).to(ttype), torch.from_numpy(labels)

    jcost, tcost = JCost.BCE(), TBCE()
    jerr, jgrad = jcost(jscores, jlabels)
    terr, tgrad = tcost(tscores, tlabels)
    assert tgrad.dtype == ttype and tuple(tgrad.shape) == shape
    _close(tgrad, jgrad, BOUNDS[dtype])
    assert abs(terr - jerr) <= BOUNDS[dtype] * max(1.0, abs(jerr))

    err, grad = costOps.bce(tscores, tlabels)
    want, wantGrad = jcostOps.bce(jscores.jax, jlabels.jax)
    assert abs(err.item() - float(want)) <= BOUNDS[dtype] * max(1.0, abs(float(want)))
    _close(grad, np.asarray(wantGrad, np.float32), BOUNDS[dtype])

    assert tcost.validate(tscores, tlabels) == jcost.validate(jscores, jlabels)
    assert tcost.validateDev(tscores, tlabels).item() == jcost.validate(jscores, jlabels)
    assert tcost.getMeanError() == pytest.approx(jcost.getMeanError(), rel=BOUNDS[dtype])


def testBCEVerifiesLabelsAndShapes(monkeypatch):
    """Under ``Config.verifyData`` a label outside [0, 1] raises, in training
    and in validation; labels must be int32 and as many a sample as the
    scores."""
    scores, labels = _bceData((3, 1, 4, 4))
    tscores = torch.from_numpy(scores)
    bad = torch.from_numpy(labels).clone()
    bad[1, 2, 3] = 2

    TBCE()(tscores, bad)   # not verified: no readback
    monkeypatch.setattr(TConfig, "verifyData", True)
    with pytest.raises(CostError, match=r"BCE labels verification failed, found index 2 \(> 1\)"):
        TBCE()(tscores, bad)
    with pytest.raises(CostError, match="verification failed"):
        TBCE().validate(tscores, bad - 3)

    with pytest.raises(CostError, match="int32"):
        TBCE()(tscores, bad.long())
    with pytest.raises(CostError, match="as many labels"):
        TBCE()(tscores, torch.zeros(3, 4, 5, dtype=torch.int32))
    with pytest.raises(CostError, match=r"\(batch, \)"):
        TBCE()(torch.zeros(3, 1), torch.zeros(3, 1, dtype=torch.int32))

"""The transformer serving slice against the JAX package: each module of the
slice, the Graph container, and the whole classifier through both packages'
``Calculator``.

Each twin builds the JAX module and the port's from the same numpy seed (the
port keeps the reference's numpy weight sampler), gives both the same numpy
input, and compares the outputs at the reference's dtype tiers: f32 within
1e-5 and bf16 within 5e-2 of max(1, max |want|) (``tensor.py``
``dtypesSupported``).  The CUDA case runs only where a card is present.
"""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.backend import device as tdevice
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.handlers import Calculator as TCalculator
from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier as tBuild
from puzzlelib_tpu_torch.ops import attention as tattn


BOUNDS = {"float32": 1e-5, "bfloat16": 5e-2}

# the narrow classifier: vocab 50, seq 16, emb 32, 2 heads, 2 layers, 3 classes
NARROW = dict(vocabsize=50, seqlen=16, embsize=32, nheads=2, nlayers=2, nclasses=3)


def _jax():
    """The JAX package's modules, containers, handlers, gpuarray and bf16 type.
    The twins skip where the JAX package does not import, as on the card's
    machine, where only the CUDA case runs."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, handlers, modules
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, handlers, gpuarray, ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The port runs on the card unless asked for the CPU: these tests ask
    (the card-only case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _twins(factory, seed=0):
    """(JAX module, port module) built from one numpy seed each."""
    J = _jax()[0]
    np.random.seed(seed)
    jmod = factory(J)
    np.random.seed(seed)
    tmod = factory(T)
    return jmod, tmod


def _randomize(jmod, tmod, seed):
    """Non-trivial biases, layer-norm scales and shifts in both twins, through
    the JAX module's table; returns the table."""
    rng = np.random.RandomState(seed)
    table = {name: var.data.get() for var, names in jmod.getVarTable().items() for name in names}

    for name, ary in table.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("b", "bias", "bq", "bk", "bv", "bo", "scale"):
            table[name] = ((leaf == "scale") + 0.1 * rng.randn(*ary.shape)).astype(np.float32)
            jmod.getVar(name).data.set(table[name])

    paramsFromNumpy(tmod, table)
    return table


def _inDtype(dtype, x):
    """The JAX and port inputs of host array x for a module in ``dtype``."""
    _, _, _, jgpu, bf16 = _jax()
    if x.dtype != np.float32 or dtype == "float32":
        return jgpu.to_gpu(x), torch.from_numpy(x)

    return jgpu.to_gpu(x.astype(bf16)), torch.from_numpy(x).to(torch.bfloat16)


def _calcMode(jmod, tmod, dtype):
    if dtype == "bfloat16":
        jmod.calcMode(_jax()[4])
        tmod.calcMode(torch.bfloat16)


def _compare(jmod, tmod, x, dtype="float32"):
    jx, tx = _inDtype(dtype, x)
    want = np.asarray(jmod(jx).get(), dtype=np.float32)
    got = tmod(tx)

    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    got = got.float().numpy()

    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BOUNDS[dtype] * max(1.0, np.abs(want).max())
    return got


# -- modules ---------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testEmbedderTwin(dtype):
    """A -1 token is padding: its row is zero in both packages."""
    jmod, tmod = _twins(lambda M: M.Embedder(20, 6, 8, initscheme="uniform", wscale=0.1))
    _calcMode(jmod, tmod, dtype)

    idx = np.random.RandomState(1).randint(-1, 20, size=(3, 6)).astype(np.int32)
    idx[0, 2] = -1

    got = _compare(jmod, tmod, idx, dtype)
    assert not got[0, 2].any()


def testEmbedderChecksItsData(monkeypatch):
    np.random.seed(0)
    mod = T.Embedder({"a": 0, "b": 1, "c": 2}, 4, 8)
    assert mod.getVocabulary() == {"a": 0, "b": 1, "c": 2} and isinstance(mod.vocab, np.ndarray)

    with pytest.raises(T.ModuleError):
        mod(torch.zeros((2, 4), dtype=torch.int64))

    with pytest.raises(T.ModuleError):
        mod(torch.zeros((2, 5), dtype=torch.int32))

    monkeypatch.setattr(TConfig, "verifyData", True)
    for bad in (3, -2):
        with pytest.raises(T.ModuleError):
            mod(torch.full((2, 4), bad, dtype=torch.int32))


@pytest.mark.parametrize("target, inshape", [((0, -1), (3, 4, 5)), ((-1, 5), (3, 4, 5)), ((0, 2, -1, 0), (3, 4, 6, 2))])
def testReshapeTwin(target, inshape):
    jmod, tmod = _twins(lambda M: M.Reshape(target, showWarnings=False))
    x = np.random.RandomState(2).randn(*inshape).astype(np.float32)

    got = _compare(jmod, tmod, x)
    assert tuple(tmod.dataShapeFrom(inshape)) == tuple(jmod.dataShapeFrom(inshape)) == got.shape

    tmod.backward(torch.ones(got.shape))
    assert tuple(tmod.grad.shape) == inshape


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testLayerNormTwin(dtype):
    """The scale and shift stay f32 under calcMode, as in the reference."""
    jmod, tmod = _twins(lambda M: M.LayerNorm(16))
    _randomize(jmod, tmod, 3)
    _calcMode(jmod, tmod, dtype)

    assert tmod.scale.dtype == tmod.bias.dtype == torch.float32
    _compare(jmod, tmod, (np.random.RandomState(4).randn(2, 5, 16) * 3 + 1).astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testGeluTwin(dtype):
    jmod, tmod = _twins(lambda M: M.Gelu())
    _calcMode(jmod, tmod, dtype)
    _compare(jmod, tmod, (np.random.RandomState(5).randn(4, 33) * 3).astype(np.float32), dtype)


def testAddTwin():
    """The n-ary sum, and its gradient handed to every input as one object."""
    jmod, tmod = _twins(lambda M: M.Add())
    J, _, _, jgpu, _ = _jax()
    xs = [np.random.RandomState(6 + i).randn(3, 4).astype(np.float32) for i in range(3)]

    want = jmod([jgpu.to_gpu(x) for x in xs]).get()
    got = tmod([torch.from_numpy(x) for x in xs])
    assert np.abs(got.numpy() - want).max() <= 1e-6

    grad = torch.ones((3, 4))
    tmod.backward(grad)
    assert len(tmod.grad) == 3 and all(g is grad for g in tmod.grad)
    assert tmod.dataShapeFrom([(3, 4)] * 3) == (3, 4) and tmod.gradShapeFrom((3, 4)) == [(3, 4)] * 3


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testSumTwin(dtype):
    jmod, tmod = _twins(lambda M: M.Sum(axis=1, useWeights=False))
    _calcMode(jmod, tmod, dtype)

    x = np.random.RandomState(7).randn(3, 16, 8).astype(np.float32)
    _compare(jmod, tmod, x, dtype)
    assert tmod.dataShapeFrom((3, 16, 8)) == (3, 8)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testMulAddConstTwin(dtype):
    """a and b are rounded to the data's type first, as in the reference."""
    jmod, tmod = _twins(lambda M: M.MulAddConst(a=1.0 / 80, b=0.3))
    _calcMode(jmod, tmod, dtype)
    _compare(jmod, tmod, np.random.RandomState(8).randn(5, 7).astype(np.float32), dtype)


@pytest.mark.parametrize("causal", [False, True])
def testAttentionTwin(causal):
    """The library route's composed attention against the reference's, with
    seqQ != seqK (the bottom-right causal offset)."""
    _jax()
    import jax.numpy as jnp
    from puzzlelib_tpu.ops.attention import attention

    rng = np.random.RandomState(9)
    q, k, v = [rng.randn(2, 3, seq, 16).astype(np.float32) for seq in (12, 20, 20)]

    want = np.asarray(attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal).numpy()
    assert np.abs(got - want).max() <= 1e-5


def testResolveAlgo():
    """Explicit values force the core; "auto" on an unmeasured signature
    keeps the reference's structural prior; anything else raises."""
    bf16, f32 = torch.bfloat16, torch.float32

    def resolve(algo, seq, dtype, device):
        return tattn.resolveAlgo(algo, 2, 4, seq, 64, False, dtype, device)

    assert resolve("flash", 8, f32, "cpu") == "flash"
    assert resolve("xla", 4096, bf16, "cuda") == "xla"
    assert resolve("auto", 1024, bf16, "cuda") == "flash"
    assert resolve("auto", 1023, bf16, "cuda") == "xla"
    assert resolve("auto", 4096, f32, "cuda") == "xla"
    assert resolve("auto", 4096, bf16, "cpu") == "xla"

    with pytest.raises(TConfig.ConfigError):
        resolve("pallas", 8, f32, "cpu")


@pytest.mark.parametrize("algo", ["xla", "flash"])
@pytest.mark.parametrize("useBias, causal", [(True, False), (False, False), (True, True), (False, True)])
def testMultiHeadAttentionTwin(useBias, causal, algo):
    """Both cores against the reference's module (whose "flash" runs its XLA
    route on the CPU); the port's "flash" runs K4's plain version on the CPU."""
    jmod, tmod = _twins(lambda M: M.MultiHeadAttention(32, 4, causal=causal, useBias=useBias,
                                                       initscheme=("xavier", "avg"), attnAlgo=algo))
    assert sorted(tmod.vars) == sorted(jmod.vars)

    if useBias:
        _randomize(jmod, tmod, 10)

    _compare(jmod, tmod, np.random.RandomState(11).randn(3, 10, 32).astype(np.float32))


@pytest.mark.parametrize("algo", ["xla", "flash"])
def testMultiHeadAttentionBf16Twin(algo):
    jmod, tmod = _twins(lambda M: M.MultiHeadAttention(32, 2, causal=True, initscheme=("xavier", "avg"),
                                                       attnAlgo=algo))
    _randomize(jmod, tmod, 12)
    _calcMode(jmod, tmod, "bfloat16")

    assert all(var.data.dtype == torch.bfloat16 for var in tmod.vars.values())
    _compare(jmod, tmod, np.random.RandomState(13).randn(2, 16, 32).astype(np.float32), "bfloat16")


def testBackwardsOfTheTrainingSliceRaise():
    """What raised before the training slice was ported runs now: the
    attention's backward and the weighted Sum (their twins are in
    tests/test_torch_transformer_train.py); a wrong gradient shape still
    raises."""
    np.random.seed(0)
    mha = T.MultiHeadAttention(8, 2)
    mha(torch.zeros((1, 3, 8)))

    mha.backward(torch.ones((1, 3, 8)))
    assert tuple(mha.grad.shape) == (1, 3, 8) and bool(torch.isfinite(mha.grad).all())

    with pytest.raises(T.ModuleError):
        mha.backward(torch.zeros((1, 3, 4)))

    weighted = T.Sum(axis=1)
    assert weighted.useWeights
    out = weighted([torch.ones((2, 3, 4)), torch.full((2, 3), 0.5)])
    assert torch.equal(out, torch.full((2, 4), 1.5))


# -- containers -----------------------------------------------------------------------------

def _fanGraph(M, C):
    """a feeds b, c and s (fan-out 3); s sums a, b and c (fan-in 3)."""
    a = M.Linear(6, 8, initscheme="he", name="a").node()
    b = M.Linear(8, 8, initscheme="he", name="b").node(a)
    c = M.Activation(M.relu, name="c").node(a)
    s = M.Add(name="s").node(a, b, c)
    d = M.Linear(8, 4, initscheme="he", name="d").node(s)
    return C.Graph(inputs=a, outputs=d, name="fan")


def testGraphFanOutFanInTwin():
    """Forward, and the backward whose input gradient at a sums three
    consumers' contributions, against the JAX package's Graph."""
    J, JC, _, jgpu, _ = _jax()
    np.random.seed(14)
    jnet = _fanGraph(J, JC)
    np.random.seed(14)
    tnet = _fanGraph(T, TC)
    _randomize(jnet, tnet, 15)

    assert sorted(tnet.nodes) == sorted(jnet.nodes) == ["a", "b", "c", "d", "s"]

    rng = np.random.RandomState(16)
    x, grad = rng.randn(5, 6).astype(np.float32), rng.randn(5, 4).astype(np.float32)

    want = jnet(jgpu.to_gpu(x)).get()
    got = tnet(torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())

    jnet.backward(jgpu.to_gpu(grad))
    tnet.backward(torch.from_numpy(grad))

    wantGrad = jnet.grad.get()
    assert np.abs(tnet.grad.numpy() - wantGrad).max() <= 1e-5 * max(1.0, np.abs(wantGrad).max())

    jvars = {name: var for var, names in jnet.getVarTable().items() for name in names}
    for var, names in tnet.getVarTable().items():
        ref = jvars[names[0]].grad.get()
        assert np.abs(var.grad.numpy() - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())

    assert tnet.dataShapeFrom((5, 6)) == (5, 4)
    assert tuple(tnet.gradShapeFrom((5, 4))) == (5, 6)


def testGraphRejectsBadWiring():
    np.random.seed(0)
    a = T.Linear(4, 4, name="a").node()
    b = T.Linear(4, 4, name="b").node(a)

    with pytest.raises(TC.ContainerError):
        TC.Graph(inputs=b, outputs=b)

    with pytest.raises(TC.ContainerError):
        TC.Graph(inputs=a, outputs=a)

    with pytest.raises(TC.NodeError):
        T.Linear(4, 4).node("a")


def testSequentialExtendNamesAsTheReference():
    """A name already taken becomes the module's index, in both packages."""
    J, JC, _, _, _ = _jax()

    def build(M, C):
        inner = C.Sequential(name="inner")
        inner.append(M.Reshape((-1, 4), showWarnings=False))
        inner.append(M.Linear(4, 4))
        inner.append(M.Gelu(name="g"))

        outer = C.Sequential(name="outer")
        outer.append(M.LayerNorm(4))
        outer.extend(inner)
        outer.extend([M.Reshape((-1, 3, 4), showWarnings=False)])
        return outer

    np.random.seed(0)
    jnet = build(J, JC)
    np.random.seed(0)
    tnet = build(T, TC)

    assert [m.name for m in tnet.graph] == [m.name for m in jnet.graph] == ["0", "1", "2", "g", "4"]
    assert sorted(name for names in tnet.getVarTable().values() for name in names) == \
        sorted(name for names in jnet.getVarTable().values() for name in names)


# -- the classifier -----------------------------------------------------------------------------

def _leaves(mod):
    return [m for m in mod.modules() if not isinstance(m, TC.Container)]


def testTransformerStructureTwin():
    """The same node names, variable names and shapes as the JAX package's
    net; calcMode, evalMode and getVarTable reach every node's module."""
    J, JC, _, _, _ = _jax()
    from puzzlelib_tpu.models.nets.transformer import buildTransformerClassifier as jBuild

    np.random.seed(0)
    jnet = jBuild(**NARROW)
    np.random.seed(0)
    tnet = tBuild(**NARROW)

    assert sorted(tnet.nodes) == sorted(jnet.nodes)
    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    tvars = {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names}
    assert tvars == jvars and len(tvars) == 37
    assert tnet.numOfParams() == sum(int(np.prod(shape)) for shape in jvars.values())

    tnet.calcMode(torch.bfloat16)
    for name, var in ((name, var) for var, names in tnet.getVarTable().items() for name in names):
        layerNorm = name.endswith(".scale") or name.endswith(".bias")
        assert var.data.dtype == (torch.float32 if layerNorm else torch.bfloat16), name

    tnet.evalMode()
    assert not any(m.training for m in tnet.modules())
    # the embedder; per layer LN, MHA, Add, LN, the MLP's 5, Add; the head's 4
    assert len(_leaves(tnet)) == 1 + 2 * (2 + 1 + 6 + 1) + 4


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("algo", ["xla", "flash"])
def testTransformerThroughCalculatorTwin(algo, dtype):
    """10 token rows (some -1 padding) at batch size 4, the last batch partial,
    through both packages' Calculator from one weight table."""
    _, _, JH, _, bf16 = _jax()
    from puzzlelib_tpu.models.nets.transformer import buildTransformerClassifier as jBuild

    np.random.seed(1)
    jnet = jBuild(**NARROW, attnAlgo=algo)
    tnet = tBuild(**NARROW, attnAlgo=algo)
    _randomize(jnet, tnet, 17)

    if dtype == "bfloat16":
        jnet.calcMode(bf16)
        tnet.calcMode(torch.bfloat16)

    tokens = np.random.RandomState(18).randint(-1, NARROW["vocabsize"], size=(10, NARROW["seqlen"]))
    tokens = tokens.astype(np.int32)

    want = JH.Calculator(jnet, batchsize=4).calcFromHost(tokens)
    got = TCalculator(tnet, batchsize=4).calcFromHost(tokens)

    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape == (10, 3)
    assert np.abs(got - want).max() <= BOUNDS[dtype] * max(1.0, np.abs(want).max())
    assert tnet.data is None and not tnet.training


def testParamsRoundTripThroughTheGraph():
    np.random.seed(2)
    net = tBuild(**NARROW)
    table = paramsToNumpy(net)

    other = tBuild(**NARROW)
    paramsFromNumpy(other, table)
    assert all(np.array_equal(ary, paramsToNumpy(other)[name]) for name, ary in table.items())


# -- the device ------------------------------------------------------------------------------

def testGetDeviceRaisesWithoutCard(monkeypatch):
    """No silent CPU: with Config.device None and no card the port raises and
    names the setting; asked for the CPU, it runs there."""
    monkeypatch.setattr(TConfig, "device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    with pytest.raises(tdevice.DeviceError, match='Config.device = "cpu"'):
        tdevice.getDevice()

    with pytest.raises(tdevice.DeviceError):
        T.LayerNorm(4)

    monkeypatch.setattr(TConfig, "device", "cpu")
    assert tdevice.getDevice() == torch.device("cpu")


@pytest.mark.cuda
def testTransformerOnCardThroughKernels(monkeypatch):
    """The narrow classifier at head dim 32 in bf16 on the card with
    attnAlgo="flash": one K4 launch per attention layer and one K1 launch per
    Linear for each batch, and logits within 5e-2 relative L2 of the f32 run
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import flash, matmul

    shape = dict(NARROW, embsize=64)
    np.random.seed(3)
    ref = tBuild(**shape, attnAlgo="flash")
    tokens = np.random.RandomState(19).randint(-1, shape["vocabsize"], size=(10, shape["seqlen"])).astype(np.int32)
    want = TCalculator(ref, batchsize=4).calcFromHost(tokens)

    monkeypatch.setattr(TConfig, "device", "cuda")
    net = tBuild(**shape, attnAlgo="flash")
    paramsFromNumpy(net, paramsToNumpy(ref))
    net.calcMode(torch.bfloat16)

    before = (flash.launches, matmul.launches)
    got = TCalculator(net, batchsize=4).calcFromHost(tokens)

    assert (flash.launches - before[0], matmul.launches - before[1]) == (2 * 3, 5 * 3)
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)

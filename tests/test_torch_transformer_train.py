"""The transformer training slice against the JAX package: the backward of
each module of the slice, the Adam step, and the narrow classifier trained by
both packages' ``Trainer`` with ``Adam`` in global state.

Each twin builds the JAX module and the port's from the same numpy seed (the
port keeps the reference's numpy weight sampler), runs the same numpy input
forward and the same output gradient backward through both, and compares
the input gradients and the accumulated parameter gradients at the
reference's dtype tiers: f32 within 1e-5 and bf16 within 5e-2 of
max(1, max |want|) (``tensor.py`` ``dtypesSupported``).  The CUDA case runs
only where a card is present.
"""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import handlers as TH
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import optimizerStateToNumpy, paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier as tBuild
from puzzlelib_tpu_torch.ops import attention as tattn
from puzzlelib_tpu_torch.ops.hopper import flash
from puzzlelib_tpu_torch.optimizers import Adam as TAdam


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}

# the narrow classifier: vocab 50, seq 16, emb 64, 2 heads of 32, 2 layers, 3 classes
NARROW = dict(vocabsize=50, seqlen=16, embsize=64, nheads=2, nlayers=2, nclasses=3)
ALPHA, STEPS, BATCH = 1e-3, 3, 8


def _jax():
    """The JAX package's modules, containers, handlers, cost, optimizers,
    gpuarray and bf16 type.  The twins skip where the JAX package does not
    import, as on the card's machine, where only the CUDA case runs."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, handlers, cost, optimizers, gpuarray, ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _onCpu(monkeypatch):
    """The port runs on the card unless asked for the CPU: these tests ask
    (the card-only case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _types(dtype):
    return (np.float32, torch.float32) if dtype == "f32" else (_jax()[6], torch.bfloat16)


def _twins(factory, seed=0):
    J = _jax()[0]
    np.random.seed(seed)
    jmod = factory(J)
    np.random.seed(seed)
    tmod = factory(T)
    return jmod, tmod


def _host(tensor):
    return tensor.detach().float().numpy()


def _close(got, want, bound):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _setVars(jmod, tmod, seed, grads=False):
    """Random values of the parameters (or, with ``grads``, of the gradient
    buffers) in both twins, in each variable's type."""
    rng = np.random.RandomState(seed)

    for name, jvar in jmod.vars.items():
        ary = (rng.randn(*jvar.data.shape) * 0.3).astype(np.float32)
        target = jvar.grad if grads else jvar.data
        target.set(ary.astype(target.dtype))
        (tmod.vars[name].grad if grads else tmod.vars[name].data).copy_(torch.from_numpy(ary))


def _backward(jmod, tmod, x, dtype, scale=1.0, momentum=0.0, seed=30):
    """Forward x (a host array; int32 passes as it is) and backward a random
    output gradient through both twins in ``dtype``, after random parameters
    (and gradient buffers, with momentum); returns the port's and the JAX
    package's module after it."""
    _, _, _, _, _, jgpu, _ = _jax()
    npT, torchT = _types(dtype)
    if dtype == "bf16":
        jmod.calcMode(npT)
        tmod.calcMode(torchT)

    _setVars(jmod, tmod, seed)
    if momentum != 0.0:
        _setVars(jmod, tmod, seed + 1, grads=True)

    xs = x if isinstance(x, list) else [x]
    jx = [jgpu.to_gpu(a if a.dtype == np.int32 else a.astype(npT)) for a in xs]
    tx = [torch.from_numpy(a if a.dtype == np.int32 else a).to(torch.int32 if a.dtype == np.int32 else torchT)
          for a in xs]

    jy = jmod(jx if isinstance(x, list) else jx[0])
    ty = tmod(tx if isinstance(x, list) else tx[0])
    _close(_host(ty), jy.get(), BOUNDS[dtype])

    g = np.random.RandomState(seed + 2).randn(*ty.shape).astype(np.float32)
    jmod.backward(jgpu.to_gpu(g.astype(npT)), scale=scale, momentum=momentum)
    tmod.backward(torch.from_numpy(g).to(torchT), scale=scale, momentum=momentum)
    return tmod, jmod


def _assertGrads(tmod, jmod, dtype, inputGrad=True):
    if inputGrad:
        tgrads = tmod.grad if isinstance(tmod.grad, list) else [tmod.grad]
        jgrads = jmod.grad if isinstance(jmod.grad, list) else [jmod.grad]
        assert len(tgrads) == len(jgrads)
        for tgrad, jgrad in zip(tgrads, jgrads):
            _close(_host(tgrad), jgrad.get(), BOUNDS[dtype])

    # the key bias's exact gradient is zero (a shift shared by all keys
    # leaves the softmax as it is): both packages add round-off there, held
    # to the tier at the scale of the query bias's gradient
    assert sorted(tmod.vars) == sorted(jmod.vars)
    for name, var in jmod.vars.items():
        assert tmod.vars[name].grad.dtype == tmod.vars[name].data.dtype
        got, want = _host(tmod.vars[name].grad), var.grad.get().astype(np.float32)

        if name == "bk":
            scale = np.abs(jmod.vars["bq"].grad.get().astype(np.float32)).max()
            assert np.abs(got - want).max() <= BOUNDS[dtype] * max(1.0, scale)
        else:
            _close(got, want, BOUNDS[dtype])


# -- modules ---------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("algo", ["xla", "flash"])
@pytest.mark.parametrize("useBias, causal", [(True, False), (False, False), (True, True), (False, True)])
def testMultiHeadAttentionBackwardTwin(useBias, causal, algo, dtype):
    """dx and the eight parameter gradients against the reference's VJP
    (whose "flash" runs its XLA route on the CPU); the port's "flash" runs
    the plain versions of K4 and K5a / K5b on the CPU."""
    jmod, tmod = _twins(lambda M: M.MultiHeadAttention(64, 2, causal=causal, useBias=useBias,
                                                       initscheme=("xavier", "avg"), attnAlgo=algo))
    x = np.random.RandomState(31).randn(3, 10, 64).astype(np.float32)

    _assertGrads(*_backward(jmod, tmod, x, dtype), dtype)
    assert tmod.gradShapeFrom((3, 10, 64)) == (3, 10, 64)


@pytest.mark.parametrize("algo", ["xla", "flash"])
def testMultiHeadAttentionAccumulatesWithScaleAndMomentum(algo):
    jmod, tmod = _twins(lambda M: M.MultiHeadAttention(32, 2, initscheme=("xavier", "avg"), attnAlgo=algo))
    buffers = {name: var.grad for name, var in tmod.vars.items()}
    x = np.random.RandomState(32).randn(2, 6, 32).astype(np.float32)

    _assertGrads(*_backward(jmod, tmod, x, "f32", scale=0.5, momentum=0.7), "f32")
    assert all(tmod.vars[name].grad is buf for name, buf in buffers.items())


def testMultiHeadAttentionSharesOneBackwardPerForward(monkeypatch):
    """``updateGrad`` and ``accGradParams`` share one ``mhaBackward`` (under
    "flash": one K5 call on the forward's saved state, no second forward);
    a new gradient, or a new core, recomputes, and both cores agree."""
    np.random.seed(33)
    mod = T.MultiHeadAttention(64, 2, causal=True, attnAlgo="flash")
    calls = {"backward": 0, "forward": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(flash, "backward", counting("backward", flash.backward))
    monkeypatch.setattr(flash, "flash", counting("forward", flash.flash))

    x = torch.from_numpy(np.random.RandomState(34).randn(2, 12, 64).astype(np.float32))
    grad = torch.from_numpy(np.random.RandomState(35).randn(2, 12, 64).astype(np.float32))

    mod(x)
    mod.backward(grad)
    assert calls == {"backward": 1, "forward": 1}
    flashGrads = [mod.grad.clone()] + [mod.vars[n].grad.clone() for n in ("Wq", "Wk", "Wv", "Wo")]

    mod.accGradParams(grad)
    assert calls == {"backward": 1, "forward": 1}

    mod.attnAlgo = "xla"
    mod.zeroGradParams()
    mod.backward(grad)
    assert calls == {"backward": 1, "forward": 1}

    xlaGrads = [mod.grad] + [mod.vars[n].grad for n in ("Wq", "Wk", "Wv", "Wo")]
    for got, want in zip(xlaGrads, flashGrads):
        assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())

    mod.evalMode()
    mod(x)
    assert mod._saved is None


@pytest.mark.parametrize("causal", [False, True])
def testAttentionBackwardTwin(causal):
    """The library route's composed VJP against the reference's, with
    seqQ != seqK (the bottom-right causal offset)."""
    _jax()
    import jax.numpy as jnp
    from puzzlelib_tpu.ops.attention import attentionBackward

    rng = np.random.RandomState(36)
    q, k, v = [rng.randn(2, 3, seq, 16).astype(np.float32) for seq in (12, 20, 20)]
    grad = rng.randn(2, 3, 12, 16).astype(np.float32)

    want = attentionBackward(*(jnp.asarray(a) for a in (q, k, v, grad)), causal=causal)
    got = tattn.attentionBackward(*(torch.from_numpy(a) for a in (q, k, v, grad)), causal)

    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-5)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testLayerNormBackwardTwin(dtype):
    """dx in the input's type; dscale and dbias in f32, also in a bf16 net."""
    jmod, tmod = _twins(lambda M: M.LayerNorm(16))
    x = (np.random.RandomState(37).randn(2, 5, 16) * 3 + 1).astype(np.float32)

    tmod, jmod = _backward(jmod, tmod, x, dtype, scale=0.5, momentum=0.25)
    _assertGrads(tmod, jmod, dtype)
    assert tmod.vars["scale"].grad.dtype == torch.float32 and tmod.grad.dtype == _types(dtype)[1]


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("inplace", [False, True])
def testGeluBackwardTwin(inplace, dtype):
    """The derivative from the input, as the reference's; in place the output
    overwrites the input and the input gradient the output gradient, in both
    packages."""
    jmod, tmod = _twins(lambda M: M.Gelu(inplace=inplace))
    x = (np.random.RandomState(38).randn(4, 33) * 3).astype(np.float32)

    tmod, jmod = _backward(jmod, tmod, x, dtype)
    _assertGrads(tmod, jmod, dtype)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testEmbedderBackwardTwin(dtype):
    """The scatter-add of the scaled gradient rows into W's gradient, with
    repeated tokens (token 3 seven times) and -1 padding, which adds nothing;
    the buffer is zeroed first whatever the momentum.  Then ``updateParams``
    scatters the same rows into W.  bf16: the port sums a token's rows in f32
    and rounds once, the reference rounds at each of its bf16 adds, within
    the bf16 tier."""
    jmod, tmod = _twins(lambda M: M.Embedder(20, 6, 8, initscheme="uniform", wscale=0.1))
    idx = np.random.RandomState(39).randint(-1, 20, size=(4, 6)).astype(np.int32)
    idx[:, 1] = 3
    idx[0, 4] = idx[2, 0] = 3
    idx[1, 2] = idx[3, 5] = -1

    tmod, jmod = _backward(jmod, tmod, idx, dtype, scale=0.5, momentum=0.7)
    assert tmod.grad is None and jmod.grad is None
    _assertGrads(tmod, jmod, dtype, inputGrad=False)

    jmod.updateParams(0.1)
    tmod.updateParams(0.1)
    _close(_host(tmod.W), jmod.W.get(), BOUNDS[dtype])

    with pytest.raises(T.ModuleError):
        tmod.gradShapeFrom((4, 6, 8))

    with pytest.raises(T.ModuleError):
        tmod.backward(torch.zeros((4, 5, 8), dtype=tmod.W.dtype))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("useWeights", [False, True])
def testSumBackwardTwin(useWeights, dtype):
    """Unweighted: the output gradient broadcast over the axis.  Weighted:
    [data, v] in, [data gradient, v gradient] out."""
    jmod, tmod = _twins(lambda M: M.Sum(axis=1, useWeights=useWeights))
    rng = np.random.RandomState(40)
    x = rng.randn(3, 16, 8).astype(np.float32)
    inputs = [x, rng.randn(3, 16).astype(np.float32)] if useWeights else x

    tmod, jmod = _backward(jmod, tmod, inputs, dtype)
    assert tuple(tmod.data.shape) == (3, 8)

    if useWeights or dtype == "f32":
        _assertGrads(tmod, jmod, dtype)
    else:
        # the reference's unweighted backward multiplies by f32 ones and hands
        # back an f32 gradient (ROADMAP Queue 3); the values are the same
        assert tmod.grad.dtype == torch.bfloat16 and jmod.grad.dtype == np.float32
        _close(_host(tmod.grad), jmod.grad.get(), BOUNDS[dtype])

    assert tmod.gradShapeFrom((3, 8)) == jmod.gradShapeFrom((3, 8))


def testSumChecksItsWeights():
    np.random.seed(0)
    mod = T.Sum(axis=1, useWeights=True)

    with pytest.raises(T.ModuleError):
        mod([torch.zeros((3, 16, 8)), torch.zeros((3, 15))])

    with pytest.raises(T.ModuleError):
        mod([torch.zeros((3, 16, 8)), torch.zeros((3, 16, 8))])


# -- Adam ------------------------------------------------------------------------------------

def _adamNet(M, C):
    net = C.Sequential(name="net")
    net.append(M.Linear(6, 5, initscheme="xavier", name="fc"))
    net.append(M.LayerNorm(5, name="ln"))
    return net


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testAdamTwin(dtype):
    """Three Adam steps in global state over the same gradients in both
    packages: the moments, per flat buffer, within 1e-6 of max |ref| (the
    same f32 arithmetic on the same gradients), under the reference's names.
    f32 parameters within 1e-6 of max |ref|.  In a bf16 net the LayerNorm's
    scale and shift stay in the f32 buffer; the bf16 buffer's parameters
    stay bf16 in the port, rounded once per step, where the reference's
    turns f32 at its first step (ROADMAP Queue 3): within three bf16
    roundings (3 * 2^-8) of max |ref|.  The bf16 constants are the
    reference's: the first step's ms is (1 - 0.999 in bf16) * grad^2, grad^2
    in f32 as XLA takes it."""
    J, JC, _, _, JOpt, _, _ = _jax()
    npT, torchT = _types(dtype)

    np.random.seed(41)
    jnet = _adamNet(J, JC)
    tnet = _adamNet(T, TC)
    paramsFromNumpy(tnet, {n: v.data.get() for v, names in jnet.getVarTable().items() for n in names})

    if dtype == "bf16":
        jnet.calcMode(npT)
        tnet.calcMode(torchT)

    jopt, topt = JOpt.Adam(alpha=ALPHA), TAdam(alpha=ALPHA)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    rng = np.random.RandomState(42)
    for step in range(3):
        for key, jvar in jopt.globalVar.items():
            g = (rng.randn(*jvar.grad.shape) * 0.5).astype(np.float32)
            jvar.grad.set(g.astype(jvar.grad.dtype))
            tvar = topt.globalVar[torch.float32 if jvar.grad.dtype == np.float32 else torch.bfloat16]
            tvar.grad.copy_(torch.from_numpy(g))

        jopt.update()
        topt.update()

        if step == 0 and dtype == "bf16":
            g = topt.globalVar[torch.bfloat16].grad.float()
            ms = topt.states[torch.bfloat16]["ms"]
            fix2 = torch.tensor(1.0 - 0.999, dtype=torch.bfloat16).item()
            assert fix2 == 0.00099945068359375
            assert torch.equal(ms, fix2 * (g * g))

    assert topt.t == jopt.t == 3
    want = {"%s.%s" % (key, entity): tensor.get() for key, state in jopt.states.items()
            for entity, tensor in state.items()}
    got = optimizerStateToNumpy(topt)
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], 1e-6)

    for key, jvar in jopt.globalVar.items():
        tvar = topt.globalVar[torch.float32 if key is np.float32 else torch.bfloat16]
        assert tvar.data.dtype == (torch.float32 if key is np.float32 else torch.bfloat16)
        bound = 1e-6 if key is np.float32 else 3 * 2.0 ** -8
        _close(_host(tvar.data), np.asarray(jvar.data.get(), np.float32), bound)


# -- the slice -------------------------------------------------------------------------------

def _sliceData():
    rng = np.random.RandomState(43)
    tokens = rng.randint(-1, NARROW["vocabsize"], size=(STEPS * BATCH, NARROW["seqlen"])).astype(np.int32)
    return tokens, rng.randint(0, NARROW["nclasses"], size=STEPS * BATCH).astype(np.int32)


def _trainSlice(H, net, cost, opt, tokens, labels):
    losses = []
    trainer = H.Trainer(net, cost, opt, batchsize=BATCH, onBatchFinish=lambda h: losses.append(h.cost.getError()))
    trainer.trainFromHost(tokens, labels, macroBatchSize=len(tokens), random=False)
    return losses


def _jaxSlice(tokens, labels):
    """The JAX package's narrow classifier (attnAlgo "flash", its XLA route
    on the CPU) trained in f32: (net, optimizer, per-step losses)."""
    _, _, JH, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu.models.nets.transformer import buildTransformerClassifier as jBuild

    np.random.seed(44)
    jnet = jBuild(**NARROW, attnAlgo="flash")
    jopt = JOpt.Adam(alpha=ALPHA)
    jopt.setupOn(jnet, useGlobalState=True)
    return jnet, jopt, _trainSlice(JH, jnet, JCost.CrossEntropy(maxlabels=NARROW["nclasses"]), jopt, tokens, labels)


def _portSlice(table, dtype, tokens, labels):
    tnet = tBuild(**NARROW, attnAlgo="flash")
    paramsFromNumpy(tnet, table)
    if dtype == torch.bfloat16:
        tnet.calcMode(dtype)

    topt = TAdam(alpha=ALPHA)
    topt.setupOn(tnet, useGlobalState=True)
    return tnet, topt, _trainSlice(TH, tnet, TCrossEntropy(maxlabels=NARROW["nclasses"]), topt, tokens, labels)


def _table(net):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in net.getVarTable().items()
            for name in names}


def testTransformerTrainingTwinF32():
    """3 steps of 8 through both packages' ``Trainer(random=False)`` and
    ``Adam`` in global state, from the same weights (-1 tokens are padding):
    per-step losses within 1e-5 relative; every variable within 1e-4
    relative L2; the Adam tables within 1e-4 relative L2.  The key biases bk
    are held to 2 * alpha * steps in absolute terms instead: their exact
    gradient is zero (a shift shared by all keys leaves the softmax as it
    is), so both packages feed Adam round-off, whose first steps move each
    entry by up to alpha in either direction."""
    tokens, labels = _sliceData()
    np.random.seed(44)
    start = paramsToNumpy(tBuild(**NARROW, attnAlgo="flash"))

    jnet, jopt, want = _jaxSlice(tokens, labels)
    tnet, topt, got = _portSlice(start, torch.float32, tokens, labels)

    assert len(got) == len(want) == STEPS and want[-1] < want[0] * 2
    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-5 * np.abs(want).max()

    jtable, ttable = _table(jnet), paramsToNumpy(tnet)
    assert sorted(jtable) == sorted(ttable)
    for name, ref in jtable.items():
        if name.endswith(".bk"):
            assert np.abs(ttable[name] - ref).max() <= 2 * ALPHA * STEPS, name
        else:
            assert np.linalg.norm(ttable[name] - ref) <= 1e-4 * np.linalg.norm(ref), name

    wantState = {"%s.%s" % (key, entity): tensor.get() for key, state in jopt.states.items()
                 for entity, tensor in state.items()}
    gotState = optimizerStateToNumpy(topt)
    assert sorted(gotState) == sorted(wantState) == ["<class 'numpy.float32'>.mg", "<class 'numpy.float32'>.ms"]
    for name, ref in wantState.items():
        assert np.linalg.norm(gotState[name] - ref) <= 1e-4 * np.linalg.norm(ref), name


def testTransformerTrainingTwinBf16():
    """The same 3 steps with the port's net in bf16 (LayerNorm parameters in
    the f32 flat buffer, the rest in the bf16 one), against the JAX
    package's f32 run: losses within 5e-2 relative, the bf16 tier.  The
    reference's own bf16 run stops in its first backward (its Sum hands an
    f32 gradient to a bf16 LayerNorm, ROADMAP Queue 3), so f32 is its
    nearest run.  Every variable is still a view of its flat buffer, and
    every one changed."""
    tokens, labels = _sliceData()
    np.random.seed(44)
    start = paramsToNumpy(tBuild(**NARROW, attnAlgo="flash"))

    _, _, want = _jaxSlice(tokens, labels)
    tnet, topt, got = _portSlice(start, torch.bfloat16, tokens, labels)

    assert set(topt.shParams) == {torch.float32, torch.bfloat16}
    assert len(got) == STEPS and np.isfinite(got).all()
    assert np.abs(np.array(got) - np.array(want)).max() <= 5e-2 * np.abs(want).max()

    for var, names in tnet.getVarTable().items():
        pack = topt.shParams[var.data.dtype].ary
        assert var.data.untyped_storage().data_ptr() == pack.untyped_storage().data_ptr(), names[0]
        assert not np.array_equal(_host(var.data), start[names[0]]), names[0]


@pytest.mark.cuda
def testTransformerTrainsOnCardThroughKernels(monkeypatch):
    """The narrow classifier in bf16 on the card with attnAlgo="flash": per
    step of 8, one K4, one K5a and one K5b launch per attention layer and one
    K1 launch per Linear forward; the losses within 5e-2 of the f32 run on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import matmul

    tokens, labels = _sliceData()
    np.random.seed(44)
    start = paramsToNumpy(tBuild(**NARROW, attnAlgo="flash"))
    _, _, want = _portSlice(start, torch.float32, tokens, labels)

    monkeypatch.setattr(TConfig, "device", "cuda")
    before = (flash.launches, flash.launchesDq, flash.launchesDkv, matmul.launches)
    _, _, got = _portSlice(start, torch.bfloat16, tokens, labels)
    after = (flash.launches, flash.launchesDq, flash.launchesDkv, matmul.launches)

    assert tuple(a - b for a, b in zip(after, before)) == (2 * STEPS, 2 * STEPS, 2 * STEPS, 5 * STEPS)
    assert np.abs(np.array(got) - np.array(want)).max() <= 5e-2 * np.abs(want).max()

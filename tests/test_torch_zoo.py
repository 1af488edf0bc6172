"""The zoo slice against the JAX package: MiniYolo, OpenPose COCO and
OpenPose MPI (``loadMiniYolo``, ``loadCOCO``, ``loadMPI``), SentiNet
(``loadSentiNet``) and its training preset (``presets.sentinet``), the
copies of ``datasets/utils.py`` and ``statistics.py``,
``optimizeForShape`` and ``tools/zooslice.py``.

Each twin builds the JAX net and the port's, carries the same numpy
weights into both (``convert.paramsFromNumpy``) and runs them on the same
seeded inputs in f32.  Outputs and gradients are held within 1e-5 of
max(1, max |want|), the f32 tier, except where a test says why a deep
net's gradients part further (its docstring gives the reason and the
reading).  The card-only case (``cuda`` marker) serves OpenPose COCO
through K2 against the CPU."""

import collections.abc
import contextlib
import io
import re
import tempfile

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch import statistics as TStatistics
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.datasets import utils as TUtils
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.models.nets import sentinet as TSentiNet
from puzzlelib_tpu_torch.models.nets.presets import sentinet as TPreset
from puzzlelib_tpu_torch.optimizers import AdaDelta as TAdaDelta
from puzzlelib_tpu_torch.tools import zooslice


F32_BOUND = 1e-5
DEEP_BOUND = 1e-4
# a deep relu net's gradients: the share of the net's largest gradient that
# one unit on the other side of a relu's kink moves them by (see
# _holdDeepGrads)
FLIP_FLOOR = 1e-2

# the sizes of tests/test_models.py's SentiNet
SENTI = dict(vocabulary=100, branches=[3, 4, 5], sentlength=20, embsize=16)


def _jax():
    """The JAX package's model zoo and gpuarray; the twins skip where it does
    not import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.models.nets", reason="the twins need the JAX package")
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models import nets

    return nets, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _err(got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _close(got, want, bound=F32_BOUND):
    assert _err(got, want) <= bound


def _jtable(jnet):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in jnet.getVarTable().items()
            for name in names}


def _grads(net):
    return {name: var.grad for var, names in net.getVarTable().items() for name in names}


def _tree(net, path=""):
    """[(path, type name)] of every module of the tree, depth first, in
    each container's order: the same in both packages."""
    found = [(path, type(net).__name__)]
    children = getattr(net, "modules", None)

    if isinstance(children, collections.abc.Mapping):
        for name, child in children.items():
            found.extend(_tree(child, "%s%s." % (path, name)))

    return found


def _loaders():
    JNets, _ = _jax()
    return {"miniyolo": (lambda: JNets.loadMiniYolo(None, numOutput=1470, initscheme="none"),
                         lambda: TNets.loadMiniYolo(None, numOutput=1470, initscheme="none"), (1, 1470)),
            "coco": (lambda: JNets.loadCOCO(None), lambda: TNets.loadCOCO(None), (1, 57, 46, 46)),
            "mpi": (lambda: JNets.loadMPI(None), lambda: TNets.loadMPI(None), (1, 71, 46, 46))}


@pytest.mark.parametrize("kind", ["miniyolo", "coco", "mpi"])
def testZooStructureTwin(monkeypatch, tmp_path, kind):
    """The same tree (module names and types, depth first), the same
    variables by name and shape, the same parameter count and output shape
    in both packages; MPI's four earlier stages nest inside the net as the
    reference builds them.  The loader's ``modelpath`` loads the file the
    JAX net wrote (OpenPose with ``assumeUniqueNames``, as its loaders
    read): every variable bit-equal to the JAX net's, so the forward is the
    one ``testMiniYoloTwin`` / ``testOpenPoseTwin`` hold to the JAX
    package's."""
    _jax()
    from puzzlelib_tpu import config as JConfig

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    jload, tload, outshape = _loaders()[kind]
    jnet, tnet = jload(), tload()
    inshape = (1, ) + zooslice.SHAPES[kind]

    assert tnet.dataShapeFrom(inshape) == jnet.dataShapeFrom(inshape) == outshape
    assert tnet.name == jnet.name
    assert _tree(tnet) == _tree(jnet)
    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    assert {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names} == jvars
    assert tnet.numOfParams() == jnet.numOfParams()

    if kind == "mpi":
        depth = max(path.count(".") for path, _ in _tree(tnet))
        assert depth >= 10 and tnet.getByName("Mconv7_stage2") is not None

    loadFile = {"miniyolo": lambda path: TNets.loadMiniYolo(path, 1470), "coco": TNets.loadCOCO,
                "mpi": TNets.loadMPI}[kind]
    _loadsJaxFile(jnet, loadFile, str(tmp_path / ("%s.hdf" % kind)), unique=kind != "miniyolo")


def _loadsJaxFile(jnet, load, path, unique):
    """``load(path)`` (a zoo loader's ``modelpath``) of the file the JAX net
    wrote: every variable of the port's net bit-equal to the JAX net's.
    Returns the port's net."""
    jnet.save(path, compress=None, assumeUniqueNames=unique)
    tnet = load(path)

    want = {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items() for name in names}
    got = {name: var.data.detach().numpy() for var, names in tnet.getVarTable().items() for name in names}
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(got[name].view(np.uint32), value.view(np.uint32)), name

    return tnet


def _carry(jnet, tnet, seed):
    """He weights from ``seed`` (``zooslice.heTable``) into both nets."""
    np.random.seed(seed)
    table = zooslice.heTable(tnet)
    for var, names in jnet.getVarTable().items():
        var.data.set(table[names[0]])

    paramsFromNumpy(tnet, table)


def _twinForwardBackward(jnet, tnet, x, seed):
    """Forward in train mode, then backward of a seeded output gradient in
    both: (the port's output, the JAX output, the input gradients, the
    parameter gradients of each)."""
    _, jgpu = _jax()
    jout, tout = jnet(jgpu.to_gpu(x)), tnet(torch.from_numpy(x))
    grad = np.random.RandomState(seed).randn(*tout.shape).astype(np.float32)

    jnet.backward(jgpu.to_gpu(grad))
    tnet.backward(torch.from_numpy(grad))
    return tout, jout, tnet.grad, jnet.grad, _grads(tnet), _grads(jnet)


def _holdDeepGrads(tgrad, jgrad, tgrads, jgrads):
    """The gradients of a deep relu net against the JAX package's: each
    parameter gradient within 1e-4 of its own largest value plus
    ``FLIP_FLOOR`` of the net's largest gradient, the input gradient within
    ``FLIP_FLOOR`` relative L2."""
    assert np.linalg.norm(_host(tgrad) - _host(jgrad)) <= FLIP_FLOOR * np.linalg.norm(_host(jgrad))
    assert sorted(tgrads) == sorted(jgrads)

    scale = max(np.abs(_host(g)).max() for g in jgrads.values())
    for name, want in jgrads.items():
        want = _host(want)
        assert np.abs(_host(tgrads[name]) - want).max() <= DEEP_BOUND * np.abs(want).max() + FLIP_FLOOR * scale, name


def testMiniYoloTwin():
    """MiniYolo at full width, batch 1 at 448 x 448, f32, He weights, the
    SoftMax's probabilities and a seeded gradient on them: the output within
    1e-5 of its largest value, the gradients by ``_holdDeepGrads``.  One of
    conv21's 200704 pre-activations lies within f32 noise of the leaky
    relu's kink and takes the other branch in the two packages (slope 1
    against 0.01): conv21.b's gradient moves by 6.0e-3 of the net's largest
    gradient, and every gradient below it by ~7e-3 relative L2, the input
    gradient's by 6.3e-3 (read here)."""
    JNets, _ = _jax()
    jnet = JNets.loadMiniYolo(None, numOutput=1470, initscheme="none")
    tnet = TNets.loadMiniYolo(None, numOutput=1470, initscheme="none")
    _carry(jnet, tnet, 14)

    x = np.random.RandomState(2).randn(1, 3, 448, 448).astype(np.float32)
    tout, jout, tgrad, jgrad, tgrads, jgrads = _twinForwardBackward(jnet, tnet, x, 3)

    assert tuple(tout.shape) == (1, 1470) and len(tgrads) == 54
    assert np.abs(_host(tout) - _host(jout)).max() <= F32_BOUND * np.abs(_host(jout)).max()
    _holdDeepGrads(tgrad, jgrad, tgrads, jgrads)


@pytest.mark.parametrize("kind", ["coco", "mpi"])
def testOpenPoseTwin(kind):
    """OpenPose at full width, batch 1 at 184 x 184 (the size of
    ``tests/test_reference_parity.py``), f32, He weights: the output maps
    within 1e-5, the input gradient and every parameter gradient of a
    seeded output gradient by ``_holdDeepGrads``.  In COCO one of
    conv3_1's 541696 pre-activations and one of Mconv3_stage2_L2's 67712
    lie within f32 noise of the relu's kink and take the other branch in
    the two packages: Mconv3_stage2_L2.W's gradient moves by 4.6e-3 of the
    net's largest gradient, the input gradient by 9.8e-4 relative L2 (read
    here); MPI's one such unit (in conv3_4) moves no gradient by more than
    4e-6 of its largest value."""
    jload, tload, _ = _loaders()[kind]
    jnet, tnet = jload(), tload()
    _carry(jnet, tnet, 16)

    x = np.random.RandomState(17).randn(1, 3, 184, 184).astype(np.float32)
    tout, jout, tgrad, jgrad, tgrads, jgrads = _twinForwardBackward(jnet, tnet, x, 18)

    assert tuple(tout.shape) == ((1, 57, 23, 23) if kind == "coco" else (1, 71, 23, 23))
    _close(tout, jout)
    _holdDeepGrads(tgrad, jgrad, tgrads, jgrads)


# -- SentiNet and its preset -------------------------------------------------------------------

class _Draws:
    """Seeded uint32 draws per dropout, in the order it asks for them; one
    feed for each package, from the same seeds."""

    def __init__(self, seed):
        self.seed, self.calls = seed, 0

    def inject(self, mod, asTensor):
        def draw(size):
            self.calls += 1
            rng = np.random.RandomState([self.seed, self.calls])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


def _sentiTwins(seed=1):
    """The JAX package's SentiNet and the port's at ``SENTI``'s sizes from
    one numpy seed, the weights carried over, the same dropout draws."""
    JNets, jgpu = _jax()
    from puzzlelib_tpu.modules import Dropout as JDropout

    np.random.seed(seed)
    jnet = JNets.loadSentiNet(None, **SENTI)
    np.random.seed(seed)
    tnet = TNets.loadSentiNet(None, **SENTI)
    paramsFromNumpy(tnet, _jtable(jnet))

    _Draws(5).inject(jnet.getAllByType(JDropout)[0], jgpu.to_gpu)
    _Draws(5).inject(tnet.getAllByType(T.Dropout)[0], lambda ary: torch.from_numpy(ary.astype(np.int64)))
    return jnet, tnet


def _sentences(count, seed=2, vocab=100, length=20):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(count, length)).astype(np.int32), rng.randint(0, 2, size=count).astype(np.int32)


def testSentiNetTwin():
    """SentiNet forward in train mode (dropout on injected draws) and
    backward: the scores, every parameter gradient (the embedding's
    scatter-add among them); row 0 of the embedding zeroed by
    ``onVocabulary``; then 3 ``AdaDelta`` steps with ``CrossEntropy``
    through ``Trainer``: the losses and weights."""
    jnet, tnet = _sentiTwins()
    assert not tnet.getByName("embedder").W[0].any() and not _jtable(jnet)["embedder.W"][0].any()

    tokens, labels = _sentences(8)
    tout, jout, _, _, tgrads, jgrads = _twinForwardBackward(jnet, tnet, tokens, 3)
    assert tuple(tout.shape) == (8, 2)
    _close(tout, jout)
    assert sorted(tgrads) == sorted(jgrads)
    for name, want in jgrads.items():
        _close(tgrads[name], want)

    _, jgpu = _jax()
    from puzzlelib_tpu.cost import CrossEntropy as JCrossEntropy
    from puzzlelib_tpu.handlers import Trainer as JTrainer
    from puzzlelib_tpu.optimizers import AdaDelta as JAdaDelta

    losses = {}
    for which, net, Opt, Cost, Train, upload in (
            ("jax", jnet, JAdaDelta, JCrossEntropy, JTrainer, jgpu.to_gpu),
            ("port", tnet, TAdaDelta, TCrossEntropy, Trainer, torch.from_numpy)):
        opt = Opt()
        opt.setupOn(net)
        trainer = Train(net, Cost(2), opt, batchsize=4)
        losses[which] = []
        trainer.onBatchFinish = lambda h, out=losses[which]: out.append(h.cost.getError())
        np.random.seed(6)
        steps, stepLabels = _sentences(12, seed=7)
        trainer.train(upload(steps), upload(stepLabels))

    assert len(losses["port"]) == 3
    _close(losses["port"], losses["jax"])
    want = _jtable(jnet)
    for name, got in paramsToNumpy(tnet).items():
        _close(got, want[name])


def _epochs(text):
    return [tuple(float(v) for v in m.groups())
            for m in re.finditer(r"Train error: (\S+)\. Val error: (\S+)", text)]


def testSentiNetPresetTwin(monkeypatch, tmp_path):
    """``presets.sentinet.train(..., saving=False)`` for one epoch on 256
    seeded sentences, split and oversampled by each package's
    ``splitData`` / ``replicateData`` from one numpy seed, against the JAX
    preset: the printed training and validation errors, the best accuracy
    and the trained weights.  Then two more epochs with ``saving=True``
    (the temporary directory moved into the test's): each preset keeps its
    best net in ``<net name>.hdf``, loads it back and returns it; the
    printed errors, the accuracy and the returned weights agree, and the
    port's net equals the file it wrote."""
    JNets, _ = _jax()
    from puzzlelib_tpu.datasets import utils as JUtils
    from puzzlelib_tpu.models.nets.presets import sentinet as JPreset

    tokens, labels = _sentences(256, seed=8)
    results = {}
    for which, (utils, preset) in {"jax": (JUtils, JPreset), "port": (TUtils, TPreset)}.items():
        np.random.seed(9)
        split = utils.splitData(tokens.copy(), labels.copy(), validation=0.1, dim=2)
        trainData, valData, trainLabels, valLabels = split
        trainData, trainLabels = utils.replicateData(trainData, trainLabels, dim=2)
        results[which] = (trainData, trainLabels, valData, valLabels)

    for got, want in zip(results["port"], results["jax"]):
        assert np.array_equal(got, want)

    jnet, tnet = _sentiTwins(seed=10)
    printed, accuracy = {}, {}
    for which, net, preset in (("jax", jnet, JPreset), ("port", tnet, TPreset)):
        trainData, trainLabels, valData, valLabels = results[which]
        out = io.StringIO()
        np.random.seed(11)
        with contextlib.redirect_stdout(out):
            _, accuracy[which] = preset.train(net, trainData, trainLabels, valData, valLabels, 2, epochs=1,
                                              saving=False)
        printed[which] = _epochs(out.getvalue())

    assert len(printed["port"]) == 1
    _close(printed["port"], printed["jax"])
    assert accuracy["port"] == accuracy["jax"]
    want = _jtable(jnet)
    for name, got in paramsToNumpy(tnet).items():
        _close(got, want[name])

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for which, net, preset in (("jax", jnet, JPreset), ("port", tnet, TPreset)):
        trainData, trainLabels, valData, valLabels = results[which]
        out = io.StringIO()
        np.random.seed(12)
        with contextlib.redirect_stdout(out):
            returned, accuracy[which] = preset.train(net, trainData, trainLabels, valData, valLabels, 2, epochs=2,
                                                     saving=True)
        assert returned is net and (tmp_path / (net.name + ".hdf")).exists()
        printed[which] = _epochs(out.getvalue())

    assert len(printed["port"]) == 2
    _close(printed["port"], printed["jax"])
    assert accuracy["port"] == accuracy["jax"]
    want = _jtable(jnet)
    for name, got in paramsToNumpy(tnet).items():
        _close(got, want[name])

    kept = TNets.loadSentiNet(str(tmp_path / (tnet.name + ".hdf")), **SENTI)
    for name, got in paramsToNumpy(kept).items():
        assert np.array_equal(got, paramsToNumpy(tnet)[name]), name


def testDatasetUtilsTwin():
    """``permutateData``, ``splitData`` (per class and proportional, with
    and without labels), ``replicateData`` and ``validate`` (through the
    statistics copies) against the JAX package's on seeded data."""
    _jax()
    from puzzlelib_tpu.datasets import utils as JUtils
    from puzzlelib_tpu import statistics as JStatistics

    rng = np.random.RandomState(12)
    data = rng.randn(97, 3).astype(np.float32)
    labels = np.concatenate([np.zeros(60), np.ones(25), np.full(12, 2)]).astype(np.int32)

    for call in (lambda U: U.permutateData(data.copy(), labels.copy()),
                 lambda U: U.splitData(data.copy(), labels.copy(), validation=0.2),
                 lambda U: U.splitData(data.copy(), labels.copy(), validation=0.2, uniformVal=False),
                 lambda U: U.splitData(data.copy(), validation=0.3),
                 lambda U: U.replicateData(data.copy(), labels.copy())):
        np.random.seed(13)
        want = call(JUtils)
        np.random.seed(13)
        got = call(TUtils)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)

    assert TUtils.getDim(labels) == JUtils.getDim(labels) == 3
    cm = [[5, 1, 0], [2, 7, 1], [0, 0, 4]]
    for fn in ("precision", "recall"):
        assert getattr(TStatistics, fn)(cm, log=False) == getattr(JStatistics, fn)(cm, log=False)
    assert TStatistics.accuracy(cm, log=False) == JStatistics.accuracy(cm, log=False)

    jnet, tnet = _sentiTwins(seed=14)
    tokens, tlabels = _sentences(40, seed=15)
    assert TUtils.validate(tnet, tokens, tlabels, batchsize=16) == JUtils.validate(jnet, tokens, tlabels, batchsize=16)


def _convNet(M, C):
    """A Sequential holding a Parallel of two conv branches, and a Graph."""
    seq = C.Sequential(name="seq")
    seq.append(M.Conv2D(2, 4, 3, pad=1, name="c1"))
    seq.append(M.Replicate(2))
    seq.append(C.Parallel().append(M.Conv2D(4, 3, 3, name="b1")).append(M.Conv2D(4, 5, (1, 3), name="b2")))

    a = M.Conv2D(2, 3, 3, name="g1").node()
    b = M.Conv2D(3, 6, 1, name="g2").node(a)
    return seq, C.Graph(inputs=a, outputs=b, name="graph")


def testOptimizeForShapeTwin(monkeypatch):
    """``optimizeForShape`` walks a Sequential, a Parallel (one shape per
    branch) and a Graph as the JAX package's does, timing each conv at its
    own input's shape through ``convNdbenchmark``; other modules do
    nothing.  Then the real ``convNdbenchmark`` on the CPU, as the preset
    calls it."""
    _jax()
    from puzzlelib_tpu import containers as JC, modules as J
    from puzzlelib_tpu.modules import convnd as jconv
    from puzzlelib_tpu_torch.modules import convnd as tconv

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jconv, "convNdbenchmark", lambda *args, **kw: calls["jax"].append(args[:2]))
    monkeypatch.setattr(tconv, "convNdbenchmark", lambda *args, **kw: calls["port"].append(args[:2]))

    for which, M, C in (("jax", J, JC), ("port", T, TC)):
        np.random.seed(16)
        seq, graph = _convNet(M, C)
        seq.optimizeForShape((2, 2, 9, 9))
        graph.optimizeForShape((2, 2, 7, 7))
        M.Activation(M.relu).optimizeForShape((2, 2))

    want = [(tuple(shape), tuple(w)) for shape, w in calls["jax"]]
    assert [(tuple(shape), tuple(w)) for shape, w in calls["port"]] == want
    assert want[1:3] == [((2, 4, 9, 9), (3, 4, 3, 3)), ((2, 4, 9, 9), (5, 4, 1, 3))] and len(want) == 5

    monkeypatch.undo()
    monkeypatch.setattr(TConfig, "device", "cpu")
    np.random.seed(16)
    seq, _ = _convNet(T, TC)
    seq.optimizeForShape((2, 2, 9, 9))


# -- the slice's tool -------------------------------------------------------------------------------

def testZooSliceOnCpu(monkeypatch):
    """``tools/zooslice.py``: the nets' K2 convs by shape (12, 15 and 12),
    the He table, the SentiNet data and a narrow SentiNet trained through
    the preset and under each optimizer on the CPU, served through
    ``Calculator``."""
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    counts = {}
    for kind, load in (("miniyolo", lambda: TNets.loadMiniYolo(None, 1470)), ("coco", lambda: TNets.loadCOCO(None)),
                       ("mpi", lambda: TNets.loadMPI(None))):
        net = load()
        counts[kind] = len(zooslice.winogradConvs(net, kind))
        assert sum(len(names.split()) for names, _, _ in zooslice.kernelConvs(net, kind)) == counts[kind]
    assert counts == {"miniyolo": 12, "coco": 15, "mpi": 12}

    monkeypatch.setattr(TConfig, "globalEvalMode", False)
    net = TNets.loadSentiNet(None, vocabulary=50, branches=[3, 4], sentlength=14, embsize=6, branchMaps=5)
    np.random.seed(0)
    table = zooslice.heTable(net)
    assert not table["3.0.0.b"].any() and table["7.W"].shape == (10, 2)

    tokens, labels = zooslice.sentiData(64, vocab=50, length=6, padding=4, lexicon=(10, 2))
    assert tokens.shape == (64, 14) and not tokens[:, :4].any() and not tokens[:, 10:].any()
    assert tokens[:, 4:10].min() >= 1
    lexicon = (tokens[:, 4:10] - 1) // 10 == labels[:, None]
    assert (lexicon.sum(axis=1) >= 2).all()

    run = zooslice.SentiRun(net, batch=8)
    result = run.preset("hopper", tokens, labels, epochs=2)
    assert len(result.trainErrors) == len(result.valErrors) == 2 and 0.0 <= result.accuracy <= 1.0
    assert result.trainRows + result.valRows >= 64
    for name in zooslice.OPTIMIZERS:
        optRun = run.optimizer(name)
        losses = []
        optRun.train("fused", tokens[:16], labels[:16], losses)
        again = []
        optRun.train("hopper", tokens[:16], labels[:16], again)
        assert losses == again and len(losses) == 2
    scores, _ = run.serve(tokens[:10])
    assert scores.shape == (10, 2)


# -- on the card -------------------------------------------------------------------------------------

@pytest.mark.cuda
def testOpenPoseCocoOnCardThroughK2(monkeypatch):
    """OpenPose COCO in bf16 on the card at batch 1 on 184 x 184: K2 takes
    its 15 Winograd convs, and the output agrees with the f32 run on the
    CPU within 5e-2 relative L2, the bf16 tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import winograd

    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    net = zooslice.build("coco")
    x = np.random.RandomState(17).randn(1, 3, 184, 184).astype(np.float32)
    want = _host(net(torch.from_numpy(x)))

    monkeypatch.setattr(TConfig, "device", "cuda")
    card = zooslice.build("coco")
    card.calcMode(torch.bfloat16)
    before = winograd.launches
    got = _host(card(torch.from_numpy(x).cuda().to(torch.bfloat16)))

    assert winograd.launches - before == 15
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)

"""The SegNet slice against the JAX package: ``tools/segslice.py``'s builder
at widths 8 to 32 in three stages (2, 2 and 3 convs) to 12 classes, on 3 x
26 x 30 inputs, so that the second pool floors 13 rows to 6 and the
decoder's unpools restore 13 and 26, in f32.

Each twin builds the JAX net and the port's from the same builder, loads
``segslice.weightTable``'s He weights into both and carries the JAX net's
running stats over through ``convert.attrsFromNumpy``; images and labels
come from ``segslice.data``.  f32 is held within 1e-5 of max(1, max |want|):
the output, the weighted ``CrossEntropy``'s loss and gradient, the input
gradient, every parameter gradient, the running stats, the losses and
weights of ``MomentumSGD`` steps, and ``dataShapeFrom`` (whose extent after
a floor pooling is the reference's, short of the forward's).  The
card-only case (``cuda`` marker) runs a 128-map SegNet through K2 and K3."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import fused
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import attrsFromNumpy, attrsToNumpy, paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.tools import segslice


F32_BOUND = 1e-5
ENCODER = ((2, 8), (2, 16), (3, 32))
SHAPE = (3, 26, 30)
BATCH, STEPS, LEARN_RATE = 2, 3, 1e-4


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, cost, optimizers, handlers, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    case sets "cuda" itself)."""
    monkeypatch.setattr(TConfig, "device", "cpu")
    monkeypatch.setattr(TConfig, "globalEvalMode", False)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=F32_BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _jvars(jnet):
    return {name: _host(var.data) for var, names in jnet.getVarTable().items() for name in names}


def _jattrs(jnet):
    return {"%s.%s" % (name, attr): _host(value) for name, child in jnet.modules.items()
            for attr, value in child.attrs.items()}


def _twins():
    """The JAX package's narrow SegNet and the port's, with
    ``weightTable``'s weights in both and the JAX net's running stats
    carried over."""
    J, JC, _, _, _, _ = _jax()
    jnet = segslice.buildNet(ENCODER, modules=J, containers=JC)
    tnet = segslice.buildNet(ENCODER)

    table = segslice.weightTable(tnet)
    for var, names in jnet.getVarTable().items():
        var.data.set(table[names[0]])

    paramsFromNumpy(tnet, table)
    attrsFromNumpy(tnet, _jattrs(jnet))
    return jnet, tnet


def _data(count=BATCH, seed=4):
    return segslice.data(count, seed=seed, shape=SHAPE, block=4)


def testSegNetStructureTwin():
    """Same modules, names and types, variables, attributes and parameter
    count, the 20 Winograd convs of the full width named from the net, and
    ``dataShapeFrom``: the reference's extents in both packages (26 rows
    answer 24 after the floor pooling of 13 to 6, the forward's 26)."""
    J, JC, _, _, _, _ = _jax()
    jnet, tnet = _twins()

    assert [(m.name, type(m).__name__) for m in tnet.graph] == [(m.name, type(m).__name__) for m in jnet.graph]
    assert {n: a.shape for n, a in paramsToNumpy(tnet).items()} == {n: a.shape for n, a in _jvars(jnet).items()}
    assert sorted(tnet.getAttrTable()) == sorted(_jattrs(jnet))
    assert tnet.numOfParams() == jnet.numOfParams() == 55748

    inshape = (BATCH, ) + SHAPE
    assert tnet.dataShapeFrom(inshape) == jnet.dataShapeFrom(inshape) == (BATCH, 12, 24, 24)
    assert [tuple(s) for _, s in segslice.convInputs(tnet, inshape)][-1] == (BATCH, 8, 26, 30)

    full = segslice.buildNet()
    assert full.numOfParams() == 29441996
    assert full.dataShapeFrom((1, ) + segslice.SHAPE) == (1, 12, 352, 480)
    assert len(segslice.winogradConvs(full)) == 20
    assert sum(len(names.split()) for names, _, _ in segslice.kernelConvs(full)) == 20
    assert ("conv4_2 conv4_3 conv4_3_D conv4_2_D", (512, 45, 60), 512) in segslice.kernelConvs(full)


def testSegNetForwardBackwardTwin():
    """A train-mode forward (each batch norm on its batch's statistics),
    the weighted cross-entropy's loss and gradient, and its backward: the
    input gradient, every parameter gradient and the running stats."""
    _, _, JCost, _, _, jgpu = _jax()
    jnet, tnet = _twins()
    images, labels = _data()
    weights = segslice.classWeights(labels)

    jout, tout = jnet(jgpu.to_gpu(images)), tnet(torch.from_numpy(images))
    assert tuple(tout.shape) == (BATCH, 12) + SHAPE[1:]
    _close(tout, jout)

    jerr, jgrad = JCost.CrossEntropy(maxlabels=12, weights=weights)(jout, jgpu.to_gpu(labels))
    terr, tgrad = TCrossEntropy(maxlabels=12, weights=weights)(tout, torch.from_numpy(labels))
    _close(np.float32(terr), np.float32(jerr))
    _close(tgrad, jgrad)

    jnet.backward(jgrad)
    tnet.backward(tgrad)
    _close(tnet.grad, jnet.grad)

    jgrads = {name: var.grad for var, names in jnet.getVarTable().items() for name in names}
    tgrads = {name: var.grad for var, names in tnet.getVarTable().items() for name in names}
    assert sorted(tgrads) == sorted(jgrads) and len(tgrads) == 41
    for name, want in jgrads.items():
        _close(tgrads[name], want)

    for name, want in _jattrs(jnet).items():
        _close(attrsToNumpy(tnet)[name], want)


def testSegNetTrainingTwin():
    """``MomentumSGD`` in global state through ``Trainer``: the per-step
    losses, the weights and the running stats after the steps; then the
    port's ``FusedTrainer`` from the same start gives the eager bits."""
    _, _, JCost, JOpt, JHandlers, _ = _jax()
    jnet, tnet = _twins()
    images, labels = _data(BATCH * STEPS, seed=5)
    weights = segslice.classWeights(labels)
    start = ({n: a.copy() for n, a in paramsToNumpy(tnet).items()}, attrsToNumpy(tnet))

    def train(trainerCls, net, cost, opt):
        losses = []
        np.random.seed(9)
        trainerCls(net, cost, opt, onBatchFinish=lambda h: losses.append(h.cost.getError()),
                   batchsize=BATCH).trainFromHost(images, labels)
        return losses

    jopt, topt = JOpt.MomentumSGD(LEARN_RATE, momRate=0.9), TMomentumSGD(LEARN_RATE, momRate=0.9)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    want = train(JHandlers.Trainer, jnet, JCost.CrossEntropy(maxlabels=12, weights=weights), jopt)
    got = train(Trainer, tnet, TCrossEntropy(maxlabels=12, weights=weights), topt)
    assert len(got) == STEPS and np.isfinite(got).all()
    _close(np.array(got), np.array(want))

    for name, ary in _jvars(jnet).items():
        _close(paramsToNumpy(tnet)[name], ary)
    for name, ary in _jattrs(jnet).items():
        _close(attrsToNumpy(tnet)[name], ary)

    eager = paramsToNumpy(tnet)
    paramsFromNumpy(tnet, start[0])
    attrsFromNumpy(tnet, start[1])
    for state in topt.states.values():
        for tensor in state.values():
            tensor.zero_()

    assert train(fused.FusedTrainer, tnet, TCrossEntropy(maxlabels=12, weights=weights), topt) == got
    assert all(np.array_equal(paramsToNumpy(tnet)[n], a) for n, a in eager.items())


def testWeightsCarriedAcross():
    """``convert`` carries a JAX SegNet's whole table (weights, then the
    running stats of a train-mode forward) into the port's, which then
    serves the JAX net's eval-mode output; and a PRelu's slopes both
    ways."""
    J, JC, _, _, _, jgpu = _jax()
    jnet = segslice.buildNet(ENCODER, modules=J, containers=JC)
    tnet = segslice.buildNet(ENCODER)
    images, _ = _data()

    np.random.seed(12)
    for var in jnet.getVarTable():
        var.data.set(np.random.randn(*var.data.shape).astype(np.float32) * 0.3)
    jnet(jgpu.to_gpu(images))

    paramsFromNumpy(tnet, _jvars(jnet))
    attrsFromNumpy(tnet, _jattrs(jnet))
    jnet.evalMode()
    tnet.evalMode()
    _close(tnet(torch.from_numpy(images)), jnet(jgpu.to_gpu(images)))

    jprelu, tprelu = J.PRelu(4, name="act"), T.PRelu(4, name="act")
    jprelu.vars["slopes"].data.set(np.array([0.1, -0.2, 0.3, 0.5], np.float32))
    paramsFromNumpy(tprelu, _jvars(jprelu))
    assert np.array_equal(paramsToNumpy(tprelu)["actslopes"], _jvars(jprelu)["actslopes"])

    x = np.random.RandomState(3).randn(2, 4, 3, 3).astype(np.float32)
    _close(tprelu(torch.from_numpy(x)), jprelu(jgpu.to_gpu(x)))


def testWeightedCrossEntropyKeepsTheReferencesGradient():
    """The reference's class-weighted cross-entropy returns w[c] * (onehot -
    softmax) / batch, each class's score weighed by that class's weight: no
    gradient of its loss, -sum(w[label] * log softmax[label]) / pixels a
    sample, which weighs every score of a pixel by its label's weight.  The
    port keeps it, as the JAX package has it; with equal weights the two
    agree (up to the reference's scale), with median-frequency weights they
    do not, which is why the SegNet slice trains without them."""
    _, _, JCost, _, _, jgpu = _jax()
    _, labels = _data()
    scores = np.random.RandomState(7).randn(BATCH, 12, *SHAPE[1:]).astype(np.float32)
    pixels = np.prod(SHAPE[1:])

    for weights, agree in ((np.ones(12, np.float32), True), (segslice.classWeights(labels), False)):
        x = torch.from_numpy(scores).requires_grad_()
        err, grad = TCrossEntropy(maxlabels=12, weights=weights)(x.detach(), torch.from_numpy(labels))
        jerr, jgrad = JCost.CrossEntropy(maxlabels=12, weights=weights)(jgpu.to_gpu(scores), jgpu.to_gpu(labels))
        _close(grad, jgrad)
        _close(np.float32(err), np.float32(jerr))

        logp = torch.log_softmax(x, dim=1).gather(1, torch.from_numpy(labels).long().unsqueeze(1)).squeeze(1)
        loss = -(torch.from_numpy(weights)[torch.from_numpy(labels).long()] * logp).sum() / pixels
        loss.backward()
        assert loss.item() / BATCH == pytest.approx(err, rel=1e-5)

        descent = -x.grad.numpy() * pixels / BATCH
        assert np.allclose(_host(grad), descent, atol=1e-5) == agree


def testSegSliceOnCpu():
    """``tools/segslice.py`` on the CPU: the seeded data (each image with
    every class in the same share) and the median-frequency weights (void's
    0, the median class's 1), a bf16 build ending in its Cast, a narrow run
    trained on the eager and fused routes (the same bits) and served, and a
    forward on pinned masks giving the run's own bits."""
    images, labels = segslice.data(2)
    assert images.shape == (2, ) + segslice.SHAPE and labels.shape == (2, 360, 480) and labels.dtype == np.int32
    shares = [np.bincount(lab.ravel(), minlength=segslice.CLASSES) / lab.size for lab in labels]
    assert np.abs(shares[0] - shares[1]).max() < 1e-2 and shares[0].min() > 0

    weights = segslice.classWeights(labels)
    assert weights[segslice.VOID] == 0 and np.median(weights[weights > 0]) == pytest.approx(1.0)

    net = segslice.build(torch.bfloat16, encoder=ENCODER)
    assert isinstance(net[-1], T.Cast) and net[-2].W.dtype == torch.bfloat16

    run = segslice.buildRun(net, batch=BATCH, weights=segslice.classWeights(_data(4)[1]), learnRate=LEARN_RATE)
    images, labels = _data(4)
    losses, again = [], []
    run.train("hopper", images, labels, losses)
    run.train("fused", images, labels, again)
    assert losses == again and len(losses) == 2 and np.isfinite(losses).all()

    out, _ = run.serve("hopper", images)
    assert out.shape == (4, 12) + SHAPE[1:] and out.dtype == np.float32

    x = torch.from_numpy(images[:2]).to(torch.bfloat16)
    first = net(x).clone()
    masks = {name: mask.clone() for name, mask in segslice.masksOf(net).items()}
    with segslice.pinnedMasks(net, masks):
        assert torch.equal(net(x), first) and sorted(masks) == ["pool1", "pool2", "pool3"]
    assert "updateData" not in vars(net[net.getModuleIndex("pool1")])


@pytest.mark.cuda
def testSegNetOnCardThroughK2AndK3(monkeypatch):
    """A SegNet of two 128-map stages in bf16 on the card at batch 2 on 20 x
    24: K2 takes its 128-map convs forward and backward and K3 their
    filters, counted from the net; the scores within 5e-2 relative L2 of
    the library route's bf16 forward on the same pooling masks
    (``segslice.pinnedMasks``: bf16 rounding flips some argmaxes from one
    route to the other, and an unpool carries each flip to another cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import winograd

    encoder, shape = ((1, 128), (2, 128)), (2, 3, 20, 24)
    monkeypatch.setattr(TConfig, "device", "cuda")
    card = segslice.build(torch.bfloat16, encoder=encoder)
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape).astype(np.float32)).cuda().to(torch.bfloat16)

    convs = segslice.winogradConvs(card, shape[0], shape[1:])
    before = (winograd.launches, winograd.filterGradLaunches)
    got = card(x)
    masks = {name: mask.clone() for name, mask in segslice.masksOf(card).items()}
    card.backward(torch.ones_like(got))

    assert winograd.launches - before[0] == 2 * len(convs) and len(convs) == 4
    assert winograd.filterGradLaunches - before[1] == len(convs)

    monkeypatch.setattr(TConfig, "convAlgo", "torch")
    with segslice.pinnedMasks(card, masks):
        want = _host(card(x))
    assert np.linalg.norm(_host(got) - want) <= 5e-2 * np.linalg.norm(want)

"""``passes.toGraph`` against the JAX package: the twin of
``tests/test_toolkit.py``'s ``toGraph`` case, and a narrow residual net
(the ResNet blocks of ``models/nets/resnet.py``) forward and backward
through both packages' ``toGraph``.  f32 is held within 1e-5 of max(1,
max |ref|), the reference's f32 tier."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy
from puzzlelib_tpu_torch.models.nets import resnet as TResNet
from puzzlelib_tpu_torch.passes import ConverterError, toGraph


BOUND = 1e-5


def _jax():
    """The JAX package's pieces for the twins; they skip where it does not
    import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, modules
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.nets import resnet
    from puzzlelib_tpu.passes import toGraph as jtoGraph

    return modules, containers, gpuarray, resnet, jtoGraph


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _close(got, want, bound=BOUND):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _toolkitNet(M, C):
    """``tests/test_toolkit.py``'s net: a Linear and relu, replicated into
    two Linears, concatenated."""
    net = C.Sequential()
    net.append(M.Linear(16, 8, name="l1"))
    net.append(M.Activation(M.relu, name="a1"))
    net.append(M.Replicate(times=2, name="rep"))
    net.append(C.Parallel().append(M.Linear(8, 4, name="l2")).append(M.Linear(8, 3, name="l3")))
    net.append(M.Concat(axis=1, name="cat"))
    return net


def testConvertToGraphMatchesNetTwin():
    """``testConvertToGraphMatchesNet``: the graph gives the net's output,
    and both packages' graphs give the same output, input gradient and
    parameter gradients on the same weights, with the same nodes."""
    J, JC, jgpu, _, jtoGraph = _jax()

    np.random.seed(0)
    jnet = _toolkitNet(J, JC)
    np.random.seed(0)
    tnet = _toolkitNet(T, TC)

    rng = np.random.RandomState(1)
    x = rng.randn(4, 16).astype(np.float32)
    grad = rng.randn(4, 7).astype(np.float32)

    seq = tnet(torch.from_numpy(x)).clone()
    tnet.reset()

    jgraph, tgraph = jtoGraph(jnet), toGraph(tnet)
    assert isinstance(tgraph, TC.Graph) and sorted(tgraph.nodes) == sorted(jgraph.nodes)

    out = tgraph(torch.from_numpy(x))
    assert torch.equal(out, seq)
    _close(out, jgraph(jgpu.to_gpu(x)).get())

    jgraph.backward(jgpu.to_gpu(grad))
    tgraph.backward(torch.from_numpy(grad))
    assert tgraph.grad.shape == (4, 16)
    _close(tgraph.grad, jgraph.grad.get())
    for var, names in jgraph.getVarTable().items():
        _close(tgraph.getVar(names[0]).grad, var.grad.get())


def _residualNet(M, C, resnet):
    """A narrow ResNet: conv1, its batch norm and relu, two bottleneck
    blocks of ``resnet.residBlock`` (a conv shortcut, then an identity one),
    an average pool and a Linear."""
    net = C.Sequential(name="narrow")
    net.append(M.Conv2D(3, 8, 3, pad=1, useBias=False, initscheme="he", name="conv1"))
    net.append(M.BatchNorm2D(8, name="bn_conv1"))
    net.append(M.Activation(M.relu, name="conv1_relu"))
    net.extend(resnet.residBlock(8, 4, 1, "2a", True, False, False, "he"))
    net.extend(resnet.residBlock(16, 4, 1, "2b", False, False, False, "he"))
    net.append(M.AvgPool2D(4, 4, name="pool5"))
    net.append(M.Flatten(name="flatten"))
    net.append(M.Linear(16 * 2 * 2, 5, initscheme="he", name="fc"))
    return net


def testResidualNetThroughToGraphTwin():
    """The narrow residual net through both packages' ``toGraph`` in train
    mode: the port's graph gives its Sequential's output bit for bit, and
    the JAX package's graph's output, input gradient, parameter gradients
    and the batch norms' running stats within the tier."""
    J, JC, jgpu, jresnet, jtoGraph = _jax()

    np.random.seed(0)
    jnet = _residualNet(J, JC, jresnet)
    tnet = _residualNet(T, TC, TResNet)
    tseq = _residualNet(T, TC, TResNet)
    table = {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}
    for net in (tnet, tseq):
        paramsFromNumpy(net, table)

    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    grad = rng.randn(2, 5).astype(np.float32)

    seqOut = tseq(torch.from_numpy(x))
    tseq.backward(torch.from_numpy(grad))

    jgraph, tgraph = jtoGraph(jnet), toGraph(tnet)
    assert sorted(tgraph.nodes) == sorted(jgraph.nodes)
    assert not any(isinstance(node.module, (T.Replicate, T.Identity)) for node in tgraph.nodes.values())

    out = tgraph(torch.from_numpy(x))
    assert torch.equal(out, seqOut)
    _close(out, jgraph(jgpu.to_gpu(x)).get())

    jgraph.backward(jgpu.to_gpu(grad))
    tgraph.backward(torch.from_numpy(grad))
    _close(tgraph.grad, jgraph.grad.get())
    _close(tgraph.grad, tseq.grad.numpy())
    for var, names in jgraph.getVarTable().items():
        _close(tgraph.getVar(names[0]).grad, var.grad.get())

    jstats = {node.module.name: node.module for node in jgraph.nodes.values() if isinstance(node.module, J.BatchNorm2D)}
    for node in tgraph.nodes.values():
        if isinstance(node.module, T.BatchNorm2D):
            _close(node.module.mean, jstats[node.module.name].mean.get())
            _close(node.module.var, jstats[node.module.name].var.get())


def testToGraphNamesAndWeights():
    """Nested nodes are named by their container path, unless
    ``assumeUniqueNames``; the graph holds the net's own modules, so a
    table loaded into the net reaches it."""
    net = _toolkitNet(T, TC)
    graph = toGraph(net)
    assert sorted(graph.nodes) == ["3_l2", "3_l3", "a1", "cat", "l1"]
    assert graph.getNodeByName("3_l2").module is net.graph[3].graph[0]

    assert "0_l1" in toGraph(_nested()).nodes and "l1" in toGraph(_nested(), assumeUniqueNames=True).nodes

    table = {name: np.full(var.data.shape, 0.5, np.float32) for var, names in net.getVarTable().items()
             for name in names}
    paramsFromNumpy(net, table)
    assert torch.equal(graph.getNodeByName("l1").module.W, torch.full((16, 8), 0.5))


def _nested():
    nested = TC.Sequential(name="outer")
    nested.append(_toolkitNet(T, TC))
    return nested


def testToGraphRefusesGlue():
    """``Glue`` may read its inputs in any way: the pass refuses it."""
    net = TC.Sequential()
    net.append(T.Linear(4, 4))
    net.append(T.Glue(fwdGlue=lambda data, _: data, bwdGlue=lambda grad, _: grad))

    with pytest.raises(ConverterError, match="Glue"):
        toGraph(net)


def testToGraphOfResNet50Builds():
    """The pass over the port's ResNet-50 (unset weights, no forward): the
    graph holds every module that computes, 176 nodes, as the JAX
    package's pass gives, and its shapes are the Sequential's."""
    from puzzlelib_tpu_torch.models.nets import loadResNet

    net = loadResNet(None, "50", initscheme="none")
    graph = toGraph(net)
    assert len(graph.nodes) == 176
    assert graph.dataShapeFrom((1, 3, 224, 224)) == net.dataShapeFrom((1, 3, 224, 224)) == (1, 1000)
    assert sum(attr.numel() for attr in graph.getAttrTable().values()) == \
        sum(attr.numel() for attr in net.getAttrTable().values())


def _residualRun(graph, classes=5):
    """A ``resnetslice.Run`` of the narrow residual net (weights from
    ``np.random.seed(0)``), as a Sequential or as its ``toGraph``."""
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.tools import resnetslice

    np.random.seed(0)
    net = _residualNet(T, TC, TResNet)
    net = toGraph(net) if graph else net
    optimizer = MomentumSGD(0.01, momRate=0.9)
    optimizer.setupOn(net, useGlobalState=True)
    return resnetslice.Run(net, optimizer, CrossEntropy(maxlabels=classes), 4)


def _residualData():
    rng = np.random.RandomState(1)
    return rng.randn(16, 3, 8, 8).astype(np.float32), rng.randint(0, 5, size=16).astype(np.int32)


def testToGraphTrainsAsTheSequential():
    """The narrow residual net and its graph through ``Trainer``,
    ``FusedTrainer`` and ``Calculator`` in global state: the same losses
    and scores, bit for bit, on the CPU."""
    x, y = _residualData()
    results = []
    for graph in (False, True):
        run = _residualRun(graph)
        losses = {algo: [] for algo in ("hopper", "fused")}
        for algo, seen in losses.items():
            run.train(algo, x, y, seen)
        results.append((losses, run.serve("hopper", x)[0]))

    (seqLosses, seqOut), (graphLosses, graphOut) = results
    assert len(graphLosses["hopper"]) == 4 and np.isfinite(graphLosses["hopper"]).all()
    assert graphLosses == seqLosses and graphLosses["fused"] == graphLosses["hopper"]
    assert np.array_equal(graphOut, seqOut)


@pytest.mark.cuda
def testToGraphOnCard(monkeypatch):
    """On the card the narrow residual net's graph gives the Sequential's
    scores bit for bit, and its losses within the f32 tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    monkeypatch.setattr(TConfig, "device", "cuda")
    x, y = _residualData()
    results = []
    for graph in (False, True):
        run = _residualRun(graph)
        losses = []
        run.train("hopper", x, y, losses)
        results.append((losses, run.serve("hopper", x)[0]))

    assert np.array_equal(results[0][1], results[1][1])
    assert max(abs(a - b) for a, b in zip(results[0][0], results[1][0])) <= BOUND * max(results[0][0])


def testFanInSumTakesChannelsLastGradients():
    """A node read by two consumers sums their gradients also where they
    come channels-last, as a conv's do on the card (a flat view of them
    failed there, ResNet-50's graph on an H100): the sum is the plain sum
    in their layout, and a graph whose input and gradients are
    channels-last gives the Sequential's gradients."""
    from puzzlelib_tpu_torch.containers.node import Node

    rng = np.random.RandomState(3)
    grads = [torch.from_numpy(rng.randn(2, 4, 3, 5).astype(np.float32)).to(memory_format=torch.channels_last)
             for _ in range(3)]
    total = Node._fanInSum(grads)
    assert torch.equal(total, grads[0] + grads[1] + grads[2])
    assert total.is_contiguous(memory_format=torch.channels_last)

    x, _ = _residualData()
    x = torch.from_numpy(x[:2]).to(memory_format=torch.channels_last)
    grad = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    results = []
    for graph in (False, True):
        np.random.seed(0)
        net = _residualNet(T, TC, TResNet)
        net = toGraph(net) if graph else net
        net(x)
        net.backward(grad)
        # by "<module>.<variable>": the graph names its modules flat
        results.append((net.grad, {".".join(names[0].split(".")[-2:]): var.grad.clone()
                                   for var, names in net.getVarTable().items()}))

    _close(results[1][0], results[0][0].numpy())
    assert sorted(results[1][1]) == sorted(results[0][1]) and len(results[0][1]) == 26
    for name, want in results[0][1].items():
        _close(results[1][1][name], want.numpy())

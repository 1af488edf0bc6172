"""The MoE trunk slice, as ``chip_smoke.py`` and the tests run it.

The trunk of ``testlib/pipelinemoe.py`` at its full width: a ``Pipeline``
of 4 ``Graph`` stages, each a Linear(64, 64) and tanh followed by a
residual ``SwitchMoE(64, capacityFactor=2.0)`` of 4 Linear(64, 64)
experts (``Add`` of the tanh and the MoE), 84,224 parameters; then a
``Slice`` of the first 10 features as the logits, ``CrossEntropy`` and
``MomentumSGD(0.05, 0.9)``, all in f32.  The script trains the stages over
a mesh with the GPipe schedule; here the same container runs on one device
as the Sequential it is, at the script's batch of 128.  Each stage's
weights come from ``np.random.seed(100 + stage)`` in the script's order,
and the gates from the JAX package's ``MoEGate`` sampler, so the two
packages build the same net (``modules`` / ``containers`` name the
package, the port's by default).

At batch 128 each MoE's capacity is 64 rows an expert, so a forward runs
20 products of K1 (``gemmF32``): the 4 trunk products (128, 64) x (64, 64)
and the 16 expert products (64, 64) x (64, 64).  The backward's products
are transposed and go to the library, as in every Linear of the port.

The script reads ``sklearn``'s digits, which the repo does not hold and
the card's machine does not have: ``data`` seeds rows of the same shape
instead (1536 to train and 256 to validate, 64 features in [0, 1] on the
digits' 17 levels, 10 classes).  A ``Run`` (``resnetslice.Run``) restarts
every ``train`` from the same weights and zero momentum on the route
``algo`` names: "hopper" (K1), "torch" (cuBLAS) or "fused"
(``FusedTrainer``, ``FusedValidator`` and ``FusedCalculator`` on K1).  The
optimizer takes local state, as the script's does, or global state
(``globalState``), which the JAX package's ``SwitchMoE`` cannot train
under.  The device is the caller's ``Config.device``.
"""

import numpy as np

from puzzlelib_tpu_torch.tools import resnetslice as Res


STAGES = 4
DIM = 64
EXPERTS = 4
CAPACITY_FACTOR = 2.0
CLASSES = 10
BATCH = 128
STEPS = 4
TRAIN_ROWS, VAL_ROWS = 1536, 256
LEARN_RATE, MOM_RATE = 0.05, 0.9


def _package(modules, containers):
    if modules is None:
        from puzzlelib_tpu_torch import containers, modules

    return modules, containers


def makeStage(index, dim=DIM, experts=EXPERTS, modules=None, containers=None):
    """Stage ``index`` of the trunk, as ``testlib/pipelinemoe.py`` builds
    it: Linear + tanh, and a residual top-1 MoE branch."""
    M, C = _package(modules, containers)
    np.random.seed(100 + index)

    inp = M.Linear(dim, dim, wscale=0.5, initscheme="gaussian", name="trunk%d" % index).node()
    act = M.Activation(M.tanh, name="trunkact%d" % index).node(inp)

    moe = M.SwitchMoE(dim, capacityFactor=CAPACITY_FACTOR, name="moe%d" % index)
    for e in range(experts):
        moe.append(M.Linear(dim, dim, wscale=0.3, initscheme="gaussian", name="expert%d" % e))
    moeNode = moe.node(act)

    out = M.Add(name="res%d" % index).node(act, moeNode)
    return C.Graph(inputs=inp, outputs=out, name="stage%d" % index)


def buildNet(stages=STAGES, dim=DIM, experts=EXPERTS, classes=CLASSES, modules=None, containers=None):
    """The trunk (a ``Pipeline`` named "trunk") and the ``Slice`` of its
    first ``classes`` features, in a Sequential "moetrunk"."""
    M, C = _package(modules, containers)

    pipe = C.Pipeline(name="trunk")
    for index in range(stages):
        pipe.append(makeStage(index, dim, experts, M, C))

    net = C.Sequential(name="moetrunk")
    net.append(pipe)
    net.append(M.Slice(name="logits")[:, :classes])
    return net


def data(trainRows=TRAIN_ROWS, valRows=VAL_ROWS, dim=DIM, classes=CLASSES, seed=0):
    """(train rows, train labels, validation rows, validation labels): each
    row its class's seeded pattern plus noise, clipped to [0, 1] and
    rounded to sixteenths (the digits' levels); labels int32."""
    rng = np.random.RandomState(seed)
    patterns = rng.uniform(0.0, 1.0, size=(classes, dim))

    labels = rng.randint(0, classes, size=trainRows + valRows).astype(np.int32)
    rows = np.clip(patterns[labels] + 0.3 * rng.randn(len(labels), dim), 0.0, 1.0)
    rows = (np.round(rows * 16.0) / 16.0).astype(np.float32)

    return rows[:trainRows], labels[:trainRows], rows[trainRows:], labels[trainRows:]


def buildRun(net=None, globalState=False, batch=BATCH, learnRate=LEARN_RATE, classes=CLASSES):
    """A ``resnetslice.Run`` of ``net`` (default ``buildNet()``) with
    ``MomentumSGD(learnRate, 0.9)`` in local or global state and
    ``CrossEntropy`` over ``classes``.  Clears ``Config.globalEvalMode``: training needs
    gradient buffers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    Config.globalEvalMode = False
    net = buildNet() if net is None else net

    optimizer = MomentumSGD(learnRate, momRate=MOM_RATE)
    optimizer.setupOn(net, useGlobalState=globalState)
    return Res.Run(net, optimizer, CrossEntropy(maxlabels=classes), batch)


def linearLaunches(net, batch, sms=132):
    """{path: (K1 launches, of them on wgmma)} of one forward of ``batch``
    rows through each Linear of ``net``, named by its path in the tree
    (the experts' names repeat from stage to stage): a trunk Linear takes
    ``batch`` rows, an expert its MoE's capacity."""
    from puzzlelib_tpu_torch.modules import Linear, SwitchMoE
    from puzzlelib_tpu_torch.ops.hopper import matmul

    rows = {}
    for path, mod in net.named_modules():
        if isinstance(mod, SwitchMoE):
            rows.update(("%s.%s" % (path, name), mod._capacity(batch)) for name, _ in mod.named_modules())

    launches = {}
    for path, mod in net.named_modules():
        if isinstance(mod, Linear):
            k, n = mod.W.shape
            route = matmul._route(rows.get(path, batch), n, k, mod.W.dtype, True, sms)
            launches[path] = (1, int(route.startswith("wgmma")))

    return launches


def stageOutputs(net, x):
    """[(stage input, stage output)] of one forward of ``x`` through the
    trunk's stages, each on the output of the one before (copies)."""
    pipe = net.graph[0]
    pairs = []
    for stage in pipe.graph:
        out = stage(x).clone()
        stage.reset()
        pairs.append((x, out))
        x = out

    return pairs

"""Pipeline + mixture-of-experts training over a mesh "stage" axis (the
counterpart of ``testlib/pipelinemoe.py``), built from modules and
containers only.

A ``Pipeline`` of 4 stages, each a Linear(64, 64) and tanh trunk with a
residual ``SwitchMoE(64, capacityFactor=2.0)`` of 4 Linear experts
(``tools/moeslice.py`` ``makeStage``), trains on the UCI digits with the
GPipe schedule: a ``runGrid`` of 4 ranks, each with a ``DeviceMesh`` of one
"stage" axis, rank s running stage s (``Pipeline.distributedGrad``, batch
128 in 4 microbatches).  The loss is the cross entropy of the last stage's
first 10 features; every rank folds the stacked gradients into its whole
pipe (``foldStageGrads``) and updates it with ``MomentumSGD(0.05, 0.9)`` in
local state, the rate times 0.93 after each epoch.  After each epoch the
256 validation rows go through ``distributedForward``.

``train`` takes the arrays; ``main`` reads scikit-learn's digits as the
JAX package's script does, trains 40 epochs and holds its gates on every
rank: the mesh schedule's output equals the eager pipe's on each 64-row
microbatch of the validation rows (within 1e-5), and the validation
accuracy is at least 0.80.  Run it with
``python -m puzzlelib_tpu_torch.testlib.pipelinemoe``: on four cards, or on
four ranks sharing card 0 (over gloo) where the machine has fewer; with
``--cpu`` on the CPU, as the JAX script runs on its virtual CPU devices.
"""

import sys

import numpy as np
import torch
import torch.nn.functional as F

from puzzlelib_tpu_torch.grid import runGrid

N_STAGES = 4
DIM = 64          # 8x8 digits, flattened
N_CLASSES = 10
BATCH, MICROBATCHES = 128, 4
EPOCHS = 40
LEARN_RATE, MOM_RATE, DECAY = 0.05, 0.9, 0.93
EAGER_BOUND = 1e-5
ACCURACY = 0.80


def loadDigits():
    """(train rows, train labels, validation rows, validation labels): the
    JAX script's split of scikit-learn's digits, pixels over 16."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    data = (digits.images.astype(np.float32) / 16.0).reshape(-1, DIM)
    labels = digits.target.astype(np.int32)

    rng = np.random.RandomState(0)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]

    split = 1536          # divisible by batch 128; validation trimmed to 256 (4 microbatches)
    return data[:split], labels[:split], data[split:split + 256], labels[split:split + 256]


def lossFn(out, target):
    """Cross entropy of the first ``N_CLASSES`` features: the trunk keeps
    its width, so the whole net trains in the mesh schedule."""
    logp = F.log_softmax(out[:, :N_CLASSES].float(), dim=-1)
    return -torch.gather(logp, 1, target.long()[:, None]).mean()


def buildPipe():
    """The trunk: a ``Pipeline`` named "trunk" of the 4 stages."""
    from puzzlelib_tpu_torch.containers import Pipeline
    from puzzlelib_tpu_torch.tools.moeslice import makeStage

    pipe = Pipeline(name="trunk")
    for index in range(N_STAGES):
        pipe.append(makeStage(index))

    return pipe


def stageMesh(nodeinfo):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(nodeinfo.device).type, (nodeinfo.gridsize, ), mesh_dim_names=("stage", ))


def accuracy(out, labels):
    return float(np.mean(np.argmax(out[:, :N_CLASSES], axis=1) == labels))


def train(nodeinfo, data, epochs=EPOCHS, onStep=None, verbose=True):
    """The recipe on this rank; returns (pipe, [(mean train loss, validation
    accuracy)] an epoch, the last validation output as numpy).  ``data`` is
    (train rows, train labels, validation rows, validation labels);
    ``onStep(pipe, loss)`` runs after each step's update."""
    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    trainData, trainLabels, valData, valLabels = data
    mesh = stageMesh(nodeinfo)

    pipe = buildPipe()
    optimizer = MomentumSGD(learnRate=LEARN_RATE, momRate=MOM_RATE)
    optimizer.setupOn(pipe, useGlobalState=False)

    x, t = gpuarray.to_gpu(trainData), gpuarray.to_gpu(trainLabels)
    history, out = [], None

    for epoch in range(epochs):
        losses = []
        for i in range(0, len(trainData), BATCH):
            loss, grads = pipe.distributedGrad(lossFn, x[i:i + BATCH], t[i:i + BATCH], mesh,
                                               microbatches=MICROBATCHES)
            pipe.foldStageGrads(grads)
            optimizer.update()

            losses.append(float(loss))
            if onStep is not None:
                onStep(pipe, loss)

        out = gpuarray.get(pipe.distributedForward(gpuarray.to_gpu(valData), mesh, microbatches=MICROBATCHES))
        history.append((float(np.mean(losses)), accuracy(out, valLabels)))

        if verbose and nodeinfo.index == 0:
            print("epoch %2d: train loss %.4f, val accuracy %.4f" % ((epoch + 1, ) + history[-1]))

        optimizer.learnRate *= DECAY

    return pipe, history, out


def eagerGap(pipe, rows, meshOut):
    """The largest gap, over max(1, max |eager|), between the mesh output
    and the eager pipe's forward of each microbatch of ``rows``."""
    from puzzlelib_tpu_torch.backend import gpuarray

    step = len(rows) // MICROBATCHES
    gap = 0.0
    for start in range(0, len(rows), step):
        eager = gpuarray.get(pipe(gpuarray.to_gpu(rows[start:start + step])))
        pipe.reset()
        gap = max(gap, float(np.abs(meshOut[start:start + step] - eager).max()) / max(1.0, float(np.abs(eager).max())))

    return gap


def node(nodeinfo, epochs=EPOCHS):
    """A rank of ``main``: the digits, ``train``, then the gates."""
    data = loadDigits()
    if nodeinfo.index == 0:
        print("digits: %d train / %d val; mesh: %d ranks on the stage axis [%s]" %
              (len(data[0]), len(data[2]), nodeinfo.gridsize, nodeinfo.device))

    pipe, history, out = train(nodeinfo, data, epochs)
    gap = eagerGap(pipe, data[2], out)

    if nodeinfo.index == 0:
        print("final val accuracy: %.4f, eager against the mesh schedule %.3e" % (history[-1][1], gap))

    if gap > EAGER_BOUND:
        raise AssertionError("the eager pipe's forward diverges from the mesh schedule (%.3e)" % gap)
    if history[-1][1] < ACCURACY:
        raise AssertionError("pipeline+MoE training failed to reach %.0f%% accuracy (%.4f)" %
                             (ACCURACY * 100, history[-1][1]))

    return history


def main(epochs=EPOCHS, cpu=False):
    """``runGrid`` of ``node`` on 4 ranks: a card each, sharing card 0
    where the machine has fewer cards, or on the CPU."""
    from puzzlelib_tpu_torch import config as Config

    if cpu:
        Config.device = "cpu"
        devices = None
    else:
        devices = None if torch.cuda.device_count() >= N_STAGES else [0] * N_STAGES

    runGrid(node, N_STAGES, epochs, devices=devices)


if __name__ == "__main__":
    main(cpu="--cpu" in sys.argv[1:])

"""The spread of ``testlib/pipelinemoe.py``'s final validation accuracy in
the JAX package and in the port, over learning rates next to the script's
0.05, and the gap between the two packages' weights after each step of
the first epoch and after each epoch.

Both packages train the script's trunk (4 stages of a Linear and tanh trunk
with a residual SwitchMoE of 4 experts) from the same seeded weights on the
same split of scikit-learn's digits, 128 rows a step in 4 microbatches,
``MomentumSGD`` at the rate with momentum 0.9, the rate times 0.93 after
each epoch: the JAX package through ``testlib/pipelinemoe.py``'s loop on 4
of its 8 virtual CPU devices, the port through its ``pipelinemoe.train`` on
a ``runGrid`` of 4 CPU ranks.  Top-1 routing is a comparison, so a last-bit
difference in a gate's logits can send a token to another expert, and the
two runs part from there; the accuracy over rates that differ by 1e-6
shows how far the 0.80 gate sits from either package's spread.

Run from the repository's root (about a minute a package and rate on a
machine of 8 cores):

    JAX_PLATFORMS=cpu python tests/pipelinemoe_spread.py [--epochs 40] [--rates 0.05,0.05000005]

It prints, at every rate, each package's accuracy after its last epoch
and the largest weight gap between the packages after each step of the
first epoch and after each epoch, then one JSON line of all of it.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from testlib import pipelinemoe as JaxScript  # noqa: E402  (sets the 8 virtual CPU devices before JAX loads)

RATES = [0.05 * (1 + d) for d in (-1e-2, -1e-6, 0.0, 1e-6, 1e-2)]
STEPS_PER_EPOCH = 1536 // 128


def _gap(a, b):
    """The largest |a - b| over the weights both hold, over max(1, max |b|)."""
    return max(float(np.abs(a[name] - b[name]).max()) / max(1.0, float(np.abs(b[name]).max())) for name in b)


def _weights(pipe):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in pipe.getVarTable().items()
            for name in names}


def jaxRun(rate, epochs):
    """(each epoch's validation accuracy, the weights after each step of
    the first epoch and after each epoch) of the JAX package's loop of
    ``testlib/pipelinemoe.py`` at ``rate``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.containers import Pipeline
    from puzzlelib_tpu.optimizers import MomentumSGD

    trainData, trainLabels, valData, valLabels = JaxScript.loadDigits()
    pipe = Pipeline(name="trunk")
    for index in range(JaxScript.N_STAGES):
        pipe.append(JaxScript.makeStage(index))

    mesh = Mesh(np.array(jax.devices()[:JaxScript.N_STAGES]), ("stage", ))
    optimizer = MomentumSGD(learnRate=rate, momRate=0.9)
    optimizer.setupOn(pipe, useGlobalState=False)

    def lossFn(out, tgt):
        logp = jax.nn.log_softmax(out[:, :JaxScript.N_CLASSES].astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[:, None], axis=1))

    accuracies, steps, weights = [], [], []
    for epoch in range(epochs):
        for i in range(0, len(trainData), 128):
            with mesh:
                _, grads = pipe.distributedGrad(lossFn, gpuarray.to_gpu(trainData[i:i + 128]),
                                                gpuarray.to_gpu(trainLabels[i:i + 128]), mesh, microbatches=4)

            pipe.foldStageGrads(grads)
            optimizer.update()
            if epoch == 0:
                steps.append(_weights(pipe))

        with mesh:
            out = pipe.distributedForward(gpuarray.to_gpu(valData), mesh, microbatches=4).get()

        accuracies.append(float(np.mean(np.argmax(out[:, :JaxScript.N_CLASSES], axis=1) == valLabels)))
        weights.append(_weights(pipe))
        optimizer.learnRate *= 0.93

    return accuracies, steps, weights


def portNode(nodeinfo, rate, epochs, outdir):
    """A rank of the port's ``pipelinemoe.train`` at ``rate``; rank 0 saves
    each epoch's validation accuracy and the weights after each step (so
    ``portRun`` can take the first epoch's steps and each epoch's end)."""
    from puzzlelib_tpu_torch.testlib import pipelinemoe
    from puzzlelib_tpu_torch.tools.gridslice import weights

    pipelinemoe.LEARN_RATE = rate
    ends = []

    def onStep(pipe, loss):
        ends.append(weights(pipe) if nodeinfo.index == 0 and
                    (len(ends) < STEPS_PER_EPOCH or (len(ends) + 1) % STEPS_PER_EPOCH == 0) else None)

    _, history, _ = pipelinemoe.train(nodeinfo, pipelinemoe.loadDigits(), epochs, onStep=onStep, verbose=False)
    if nodeinfo.index == 0:
        np.savez(Path(outdir) / "port.npz", accuracies=np.array([acc for _, acc in history]),
                 **{"%d/%s" % (step, name): value for step, end in enumerate(ends) if end is not None
                    for name, value in end.items()})


def portRun(rate, epochs):
    """(each epoch's validation accuracy, the weights after each step of
    the first epoch and after each epoch) of the port's
    ``pipelinemoe.train`` at ``rate`` on 4 CPU ranks."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.grid import runGrid

    Config.device = "cpu"
    with tempfile.TemporaryDirectory() as outdir:
        runGrid(portNode, JaxScript.N_STAGES, rate, epochs, outdir)
        saved = dict(np.load(Path(outdir) / "port.npz"))

    weights = [{} for _ in range(epochs * STEPS_PER_EPOCH)]
    for key, value in saved.items():
        if key != "accuracies":
            step, name = key.split("/", 1)
            weights[int(step)][name] = value

    return ([float(acc) for acc in saved["accuracies"]], weights[:STEPS_PER_EPOCH],
            weights[STEPS_PER_EPOCH - 1::STEPS_PER_EPOCH])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--rates", default=",".join(repr(rate) for rate in RATES))
    args = parser.parse_args()

    runs = []
    for rate in (float(text) for text in args.rates.split(",")):
        jaxAcc, jaxSteps, jaxEpochs = jaxRun(rate, args.epochs)
        portAcc, portSteps, portEpochs = portRun(rate, args.epochs)
        stepGaps = [_gap(port, ref) for port, ref in zip(portSteps, jaxSteps)]
        gaps = [_gap(port, ref) for port, ref in zip(portEpochs, jaxEpochs)]
        runs.append({"rate": rate, "jax": jaxAcc, "port": portAcc, "stepGaps": stepGaps, "gaps": gaps})

        print("rate %r: final validation accuracy JAX %.4f, port %.4f; largest weight gap by step of the first epoch "
              "%s; by epoch %s" % (rate, jaxAcc[-1], portAcc[-1], " ".join("%.1e" % gap for gap in stepGaps),
                                   " ".join("%.1e" % gap for gap in gaps)), flush=True)

    print(json.dumps({"epochs": args.epochs, "runs": runs}))


if __name__ == "__main__":
    main()

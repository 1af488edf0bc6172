"""VGG-16 training-step benchmark (the counterpart of
``testlib/optimizenet.py``): ``SGD`` in global state and
``CrossEntropy(1000)`` on one seeded batch, the eager ``Trainer.train`` and
then the ``FusedTrainer.train`` step (one CUDA graph replay a step on the
card), each timed by ``backend.device.timeKernel`` over ``looplength``
calls after one untimed call.  The net's weights are the "none" scheme's
(uninitialised memory), as in the script: the times do not depend on them.

``dtype`` sets the net's type (None: f32, as the script).  Kernels K2,
K2-bwd and K3 take bf16 only: in bf16 they run 10 of VGG-16's 13 convs a
step each, and K1 its fc6-fc8.
"""

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.device import timeKernel
from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.fused import FusedTrainer
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.models.nets.vgg import loadVGG
from puzzlelib_tpu_torch.optimizers import SGD


def buildRun(batchsize=16, dtype=None):
    """(net, batch, labels, optimizer, cost): VGG-16, one batch of
    ``np.random.normal`` images and ``np.random.randint`` labels on the
    device, SGD in global state."""
    net = loadVGG(None, "16")
    if dtype is not None:
        net.calcMode(dtype)

    size = (batchsize, 3, 224, 224)

    batch = gpuarray.to_gpu(np.random.normal(size=size).astype(np.float32), dtype=dtype)
    labels = gpuarray.to_gpu(np.random.randint(low=0, high=1000, size=(batchsize, ), dtype=np.int32))

    optimizer = SGD()
    optimizer.setupOn(net, useGlobalState=True)

    return net, batch, labels, optimizer, CrossEntropy(maxlabels=1000)


def main(batchsize=16, looplength=100, dtype=None):
    """Seconds a step of the eager and of the fused trainer."""
    net, batch, labels, optimizer, cost = buildRun(batchsize, dtype)

    print("Started benchmarking %s ..." % net.name)

    trainer = Trainer(net, cost, optimizer)
    eager = timeKernel(trainer.train, args=(batch, labels), looplength=looplength,
                       logname="Eager per-op %s" % net.name, normalize=True)

    fused = FusedTrainer(net, cost, optimizer)
    fusedSecs = timeKernel(fused.train, args=(batch, labels), looplength=looplength,
                           logname="Fused step %s" % net.name, normalize=True)

    print("%s at batch %d: eager %.6f s a step, fused %.6f s a step" % (net.name, batchsize, eager, fusedSecs))
    return eager, fusedSecs


if __name__ == "__main__":
    main()

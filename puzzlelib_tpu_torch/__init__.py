"""puzzlelib_tpu_torch - the PyTorch / CUDA port of puzzlelib_tpu for NVIDIA Hopper.

The same imperative Modules/Containers/Handlers API as the JAX package
``puzzlelib_tpu``, which stays beside it as the reference.  Modules are
``torch.nn.Module``s holding plain tensors; the kernels that the JAX package
wrote in Pallas for the TPU are hand-written CUDA C++ for sm_90a under
``ops/hopper`` (sources in ``csrc``), built with ``nvcc`` at first use.

Ported so far: VGG-16's serving path (``models.nets.loadVGG`` -> ``calcMode``
-> ``handlers.Calculator.calcFromHost``) and its training path (``net.pop()``
-> ``calcMode`` -> ``optimizers.MomentumSGD.setupOn(net,
useGlobalState=True)`` -> ``handlers.Trainer(net, cost.CrossEntropy(), opt)
.trainFromHost``), and the transformer classifier's serving path
(``models.nets.buildTransformerClassifier(..., attnAlgo="flash")`` ->
``calcMode`` -> ``handlers.Calculator.calcFromHost``) and its training path
(``calcMode`` -> ``optimizers.Adam(alpha=1e-3).setupOn(net,
useGlobalState=True)`` -> ``handlers.Trainer(net,
cost.CrossEntropy(maxlabels=2), opt, batchsize=64).trainFromHost``, through
the flash-attention backward), serving engines (``converter.engine``), and
the kernel-measurement path (``benchmarks``, the probes under ``tools``,
``profiler``).

The port runs on the CUDA card; a run on the CPU asks for it with
``Config.device = "cpu"``.
"""

from puzzlelib_tpu_torch import config as Config

__version__ = "0.1.0"

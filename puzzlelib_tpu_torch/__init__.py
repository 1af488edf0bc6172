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
the flash-attention backward), the CNN training slice (LeNet, the CIFAR-10
NIN and the ImageNet NiN through ``Trainer`` and ``Validator``), the fused
step over these (``fused.FusedTrainer``, ``FusedValidator``,
``FusedCalculator``: each step a CUDA graph, recorded once and replayed),
serving engines (``converter.engine``), the kernel-measurement path
(``benchmarks``, the probes under ``tools``, ``profiler``), and the data
path (the dataset loaders of ``datasets``, the threaded providers of
``transformers`` and the loaders' training scripts under ``testlib``),
checkpoints (``hdf``, ``blueprint``), and the converters and tooling: the
ONNX exporter and the Caffe and MXNet importers (``converter.onnx``,
``converter.caffe``, ``converter.mxnet``), ``board``, ``unittester`` and
``benchmarks.enginespeed``.

The port runs on the CUDA card; a run on the CPU asks for it with
``Config.device = "cpu"``.
"""

from puzzlelib_tpu_torch import config as Config

__version__ = "0.1.0"

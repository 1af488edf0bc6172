"""Hand-written Hopper (sm_90a) kernels, the port of ``puzzlelib_tpu/ops/pallas``.

Each kernel module holds the wrapper that launches the CUDA C++ kernel from
``puzzlelib_tpu_torch/csrc``, the same function in plain PyTorch (``plain``),
which CPU tensors take, and a launch counter (``launches``):

- ``matmul``   K1, the tiled GEMM, in f32, bf16, f16 and int8 -> int32
  (K1-int8, counter ``launchesInt8``) (``ops/pallas/matmul.py``);
- ``winograd`` K2, the fused Winograd F(2x2, 3x3) forward conv, which also
  runs the stride-1 bwd-data (``dataGrad``), and K3, the transform-domain
  bwd-filter (``filterGrad``, plain version ``filterGradPlain``, counter
  ``filterGradLaunches``) (``ops/pallas/winograd.py``);
- ``flash``    K4, the flash-attention forward, which returns each row's
  logsumexp beside the output, and K5a / K5b, its backward (``backward``,
  plain version ``backwardPlain``, counters ``launchesDq`` and
  ``launchesDkv``; ``FlashAttention`` under autograd) (``ops/pallas/flash.py``);
- ``probe``    K0, the install probe ``2 x`` (``checkinstall.py``).

The kernels that an engine's forward reaches are also custom operators with
shape functions, ``matmul.matmulOp`` (``puzzlelib::matmul``, every type),
``winograd.conv2dOp`` (``puzzlelib::winograd_conv2d``) and ``flash.flashOp``
(``puzzlelib::flash``): their wrappers hand them the fake tensors of a
``torch.export`` trace, so that an engine's graph records the kernels, and
launch directly on real tensors.  The training-only kernels (K2 as
bwd-data, K3, K5a, K5b) are not: no engine runs them.

The measurement probes, the ports of the repo-root ``tools/*_probe.py``
kernels, which no model runs:

- ``streamcopy`` P3, the streaming ``x + 1`` (``tools/roofline_probe.py``
  ``copyKernel``);
- ``phasesplit`` P2, the stride-2 phase-slab copy
  (``tools/strided_dma_probe.py`` ``_kernel``);
- ``tapdot``   P1, the pitch-row tap-dot direct conv
  (``tools/tapdot_probe.py`` ``_kernel``).

``build`` compiles the sources with ``nvcc`` at the first CUDA call.
"""

"""Hand-written Hopper (sm_90a) kernels, the port of ``puzzlelib_tpu/ops/pallas``.

Each kernel module holds the wrapper that launches the CUDA C++ kernel from
``puzzlelib_tpu_torch/csrc``, the same function in plain PyTorch (``plain``),
which CPU tensors take, and a launch counter (``launches``):

- ``matmul``   K1, the tiled GEMM (``ops/pallas/matmul.py``);
- ``winograd`` K2, the fused Winograd F(2x2, 3x3) forward conv, which also
  runs the stride-1 bwd-data (``dataGrad``), and K3, the transform-domain
  bwd-filter (``filterGrad``, plain version ``filterGradPlain``, counter
  ``filterGradLaunches``) (``ops/pallas/winograd.py``);
- ``flash``    K4, the flash-attention forward, which returns each row's
  logsumexp beside the output, and K5a / K5b, its backward (``backward``,
  plain version ``backwardPlain``, counters ``launchesDq`` and
  ``launchesDkv``; ``FlashAttention`` under autograd) (``ops/pallas/flash.py``).

``build`` compiles the sources with ``nvcc`` at the first CUDA call.
"""

"""Global configuration flags of the PyTorch port.

Counterpart of ``puzzlelib_tpu/config.py``: a plain module of globals that the
backend reads at each call, so setting one takes effect at the next op.

- ``device``: where modules put their parameters and handlers their batches.
  None means the first CUDA card, and raises when there is none
  (``backend.device.getDevice``): a run on the CPU sets "cpu" explicitly.
- ``matmulPrecision``: "highest" keeps f32 products and convs in full f32,
  as the reference's default does on the TPU: while it holds, the backend
  turns off TF32 in cuBLAS and cuDNN (``torch.backends.cuda.matmul.allow_tf32``
  and ``torch.backends.cudnn.allow_tf32``) and cuBLAS's reduced-precision
  reductions of bf16 and f16 products.  Any other value allows them.
- ``gemmAlgo`` / ``convAlgo``: "hopper" (the default) sends the products and
  convs that a hand-written Hopper kernel takes to that kernel, on CUDA
  tensors; "torch" sends everything to the library call; "auto" sends each
  to the route that ``optimizeForShape`` measured faster at its shape and
  direction (``route``): K1 against cuBLAS in ``ops.hopper.matmul._dispatch``
  (hand only if strictly faster; an unmeasured product takes the hand
  kernel where min(m, n, k) >= 1024 and n and k are multiples of 128, the
  reference's static prior), K2 / K2-bwd / K3 against cuDNN in
  ``ops.conv._algoChoice`` (hand only below 0.97x the library; an
  unmeasured conv takes the library).
- ``attentionAlgo``: the attention core of ``MultiHeadAttention`` modules
  built without an ``attnAlgo`` (the reference's names, which scripts pass
  as ``attnAlgo=``).  "flash" is the hand-written flash kernels, K4 forward
  and K5a / K5b backward, on CUDA tensors and their plain PyTorch versions
  on CPU tensors; "xla" names the library route here: the composed
  attention in PyTorch and its VJP, the counterpart of the reference's XLA
  route; "auto" takes the choice that ``measureAttnChoice`` recorded for the
  signature (``ops.attention._attnChoice``), and for an unmeasured one
  "flash" for bf16 on the card at seq >= 1024, else "xla" (the reference's
  structural prior).
- ``dispatchEpoch``: bumped by every write into a measured table
  (``recordChoice``), so that a fused step recorded under an older choice
  records again.
- ``globalEvalMode``: modules start in eval mode and variables get no
  gradient buffers.
- ``verifyData``: costs check that the labels lie in range (one readback
  per batch).
- ``disableModuleCompatChecks``: ``Sequential`` skips its inplace
  compatibility check.
- ``debugAllocator``: ``gpuarray.empty`` poisons what it allocates (NaN for
  floats, the type's largest value for integers, 0 otherwise), so a read
  of memory nobody wrote shows; ``unittester`` sets it.
"""

import sys
import logging


class ConfigError(Exception):
    pass


libname = "puzzlelib_tpu_torch"
logger = None

device = None
matmulPrecision = "highest"

ALGOS = ("hopper", "torch", "auto")
gemmAlgo = "hopper"
convAlgo = "hopper"

ATTENTION_ALGOS = ("auto", "xla", "flash")
attentionAlgo = "auto"

dispatchEpoch = 0

globalEvalMode = False
disableDtypeShapeChecks = False
disableModuleCompatChecks = False
verifyData = False
showWarnings = True
debugAllocator = False


def checkAlgo(algo):
    """``algo`` when it is one of ``ALGOS``; raises ``ConfigError`` else."""
    if algo not in ALGOS:
        raise ConfigError("Unknown algo %r (expected one of %s)" % (algo, ", ".join(ALGOS)))

    return algo


def route(algo, table=None, key=None, prior=False):
    """True when ``algo`` sends the call to the hand kernel: "hopper"
    always, "torch" never, "auto" where ``table`` holds "hopper" for
    ``key``, and ``prior`` where it holds nothing for it."""
    if checkAlgo(algo) != "auto":
        return algo == "hopper"

    choice = table.get(key)
    return prior if choice is None else choice == "hopper"


def recordChoice(table, key, choice):
    """Write a measured choice into a dispatch table and bump
    ``dispatchEpoch``."""
    global dispatchEpoch

    table[key] = choice
    dispatchEpoch += 1


def clearChoices(*tables):
    """Empty measured dispatch tables and bump ``dispatchEpoch``."""
    global dispatchEpoch

    for table in tables:
        table.clear()
    dispatchEpoch += 1


def getLogger():
    global logger

    if logger is not None:
        return logger

    logger = logging.getLogger(libname)
    logger.setLevel(logging.INFO)

    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))

    logger.addHandler(handler)
    return logger

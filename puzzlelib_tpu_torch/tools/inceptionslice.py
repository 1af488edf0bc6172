"""The Inception serving slice, as ``chip_smoke.py`` and the tests run it.

Inception-BN (``loadInceptionBN``, 3 x 224 x 224 in, 1000 classes,
11,285,224 parameters) and Inception-v3 (``loadInceptionV3``, 3 x 299 x 299
in, 1008 classes, 23,850,960 parameters) at full width, in bf16 with their
batch norms in f32, served at batch 32 through ``Calculator.calcFromHost``
and ``FusedCalculator.calcFromHost`` with their SoftMax, on seeded images
(the repo holds no ImageNet file).  Weights come from ``np.random.seed(0)``
and the He scheme, the running stats are the batch norms' start values
(mean 0, variance 1).

On the card K1 takes ``fc1`` of each net; K2 takes Inception-BN's
``conv_4a_double_3x3_1`` and ``conv_4b_double_3x3_1`` (128 -> 128 at 14 x 14,
``winograd.applicable``); no conv of Inception-v3 is K2's (no 3x3 stride-1
conv there has both channel counts a multiple of 128).  Every other conv,
the pools and the batch norms go to cuDNN and PyTorch's ops.  The device is
the caller's ``Config.device``.
"""

import numpy as np

from puzzlelib_tpu_torch.tools import resnetslice as Res


BATCH = 32
SHAPES = {"bn": (3, 224, 224), "v3": (3, 299, 299)}
CLASSES = {"bn": 1000, "v3": 1008}
NAMES = {"bn": "Inception-BN", "v3": "Inception-v3"}

# (name, x shape at batch 1, output maps) of Inception-BN's convs that K2
# takes; (name, K, N) of each net's fc1
KERNEL_CONVS = [("conv_4a_double_3x3_1 conv_4b_double_3x3_1", (128, 14, 14), 128)]
FC1 = {"bn": ("fc1", 1024, 1000), "v3": ("fc1", 2048, 1008)}


def data(kind, count, seed=1):
    """``count`` seeded f32 images of ``kind``'s shape."""
    return np.random.RandomState(seed).randn(count, *SHAPES[kind]).astype(np.float32)


def build(kind, initscheme="he"):
    """``kind``'s net ("bn" or "v3") with its SoftMax, weights from
    ``np.random.seed(0)``, in eval mode: serving needs no gradient buffers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.models.nets import loadInceptionBN, loadInceptionV3

    np.random.seed(0)
    evalMode, Config.globalEvalMode = Config.globalEvalMode, True
    try:
        return (loadInceptionBN if kind == "bn" else loadInceptionV3)(None, initscheme=initscheme)
    finally:
        Config.globalEvalMode = evalMode


def buildRun(kind, net=None, dtype=None, batch=BATCH):
    """``resnetslice.Served`` of ``net`` (default ``build(kind)``) in
    ``dtype`` (bf16 by default; the batch norms stay f32): its
    ``serve(algo, images)``."""
    import torch

    net = build(kind) if net is None else net
    net.calcMode(torch.bfloat16 if dtype is None else dtype)
    return Res.Served(net, batch)

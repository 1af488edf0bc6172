"""The U-Net slice, as ``chip_smoke.py`` and the tests run it.

U-Net (``models/nets/unet.py``) at full width, 31,804,225 parameters, on
1 x 512 x 512 inputs, the grey-level EM sections of the ISBI 2012
segmentation challenge that the U-Net paper segments, in bf16 at batch 4:
trained without its top sigmoid (``BCE`` fuses it) through
``Trainer.trainFromHost`` with ``MomentumSGD(1e-3, 0.99)`` in global state
(the paper's momentum; 1e-3 is the largest of 1e-2, 1e-3 and 1e-4 at which
no route's loss grows from a step to the next over the 8 steps: at 1e-2
the eighth step's loss rises on every route, at 1e-4 the second's),
validated through ``Validator.validateFromHost`` with ``BCE`` (the share of
pixels whose logit's sign misses the mask) and served with the sigmoid
through ``Calculator.calcFromHost``.  The repo holds no ISBI file: the
masks are seeded smoothed noise thresholded at 0 (int32, (N, 512, 512)),
and the images seeded f32 noise with the mask's foreground brighter.

On the card K2 takes the forward, K2 the bwd-data and K3 the bwd-filter of
the 15 3x3 convs whose channels are multiples of 128 (``winograd.applicable``,
counted from the net by ``resnetslice.winogradConvs``): conv_2_2 and
conv_3_1 to conv_8_2, 128 to 1024 maps at 256^2 down to 32^2.  The 2x2
stride-2 deconvs go to ``conv_transpose2d`` and the library's bwd-filter;
conv_1_1, conv_1_2, conv_2_1, conv_8_3, block 9's convs and ``score`` to
cuDNN, as ``lax`` takes them in the JAX package.

Weights come from ``np.random.seed(0)`` and the He scheme.  A ``Run``
(``tools/resnetslice.py``'s, whose ``Calculator`` and ``FusedCalculator``
serve the net followed by its sigmoid) restarts every ``train`` from the
same weights, zero momentum and the dropout generator's seed, so that the
routes draw the same masks, on the route that ``algo`` names: "hopper" (the
hand kernels), "torch" (the library) or "fused" (``FusedTrainer``,
``FusedValidator`` and ``FusedCalculator`` on the hand kernels).  The
device is the caller's ``Config.device``.
"""

import numpy as np

from puzzlelib_tpu_torch.tools import resnetslice as Res


BATCH = 4
STEPS = 8
LEARN_RATE, MOM_RATE = 1e-3, 0.99
SHAPE = (1, 512, 512)
SMOOTHING = 16

# U-Net's 3x3 conv shapes that K2 and K3 take: (convs, x shape at batch 1,
# output maps) at a 512 x 512 input
KERNEL_CONVS = [
    ("conv_2_2 conv_7_3 conv_8_2", (128, 256, 256), 128), ("conv_3_1", (128, 128, 128), 256),
    ("conv_3_2 conv_6_3 conv_7_2", (256, 128, 128), 256), ("conv_7_1", (512, 128, 128), 256),
    ("conv_4_1", (256, 64, 64), 512), ("conv_4_2 conv_6_2", (512, 64, 64), 512),
    ("conv_6_1", (1024, 64, 64), 512), ("conv_5_1", (512, 32, 32), 1024), ("conv_5_2", (1024, 32, 32), 1024),
    ("conv_8_1", (256, 256, 256), 128),
]


def data(count, seed=1, shape=SHAPE):
    """``count`` seeded f32 images of ``shape`` and their int32 masks
    (count, height, width): noise at 1/SMOOTHING of the size, repeated up
    to it and thresholded at 0; the image is unit noise plus 0.5 on the
    foreground and minus 0.5 on the background."""
    rng = np.random.RandomState(seed)
    _, height, width = shape

    coarse = rng.randn(count, height // SMOOTHING, width // SMOOTHING)
    masks = (coarse.repeat(SMOOTHING, axis=1).repeat(SMOOTHING, axis=2) > 0).astype(np.int32)

    images = rng.randn(count, *shape).astype(np.float32) + (masks[:, None] - 0.5).astype(np.float32)
    return images, masks


def build(initscheme="he"):
    """U-Net with its sigmoid, weights from ``np.random.seed(0)``."""
    from puzzlelib_tpu_torch.models.nets import loadUNet

    np.random.seed(0)
    return loadUNet(None, initscheme=initscheme)


def buildRun(net=None, dtype=None, batch=BATCH):
    """A ``Run`` of ``net`` (default ``build()``) in ``dtype`` (bf16 by
    default): its sigmoid popped for training and appended again behind it
    for serving, ``MomentumSGD(LEARN_RATE, 0.99)`` in global state and
    ``BCE``.  Clears ``Config.globalEvalMode``: training needs gradient
    buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.containers import Sequential
    from puzzlelib_tpu_torch.cost import BCE
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    Config.globalEvalMode = False
    net = build() if net is None else net
    dtype = torch.bfloat16 if dtype is None else dtype

    sigmoid = net.pop()   # BCE takes the logits
    net.calcMode(dtype)

    served = Sequential(name="unet-served")
    served.append(net)
    served.append(sigmoid)
    served.calcMode(dtype)

    optimizer = MomentumSGD(LEARN_RATE, momRate=MOM_RATE)
    optimizer.setupOn(net, useGlobalState=True)
    return Res.Run(net, optimizer, BCE(), batch, served=served)

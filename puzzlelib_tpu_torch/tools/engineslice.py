"""The serving-engine slice, as ``chip_smoke.py`` and the tests run it.

The configuration is the JAX package's own engine benchmark,
``puzzlelib_tpu/benchmarks/enginespeed.py`` with ``--net vgg16 --batch 32
--dtypes bfloat16,int8``: VGG-16 at full width (224 x 224 x 3, 1000
classes) with f32 He weights from ``np.random.seed(0)``, without its final
SoftMax, so the output is the logits (``buildNet``); an int8 engine
calibrated by ``DataCalibrator(batchsize=16, algo="minmax")`` on 64 seeded
images and a bf16 engine, each built by ``buildEngine`` at the input shape
(32, 3, 224, 224) and loaded back from disk by ``Engine``, as a deployment
process loads it (``buildEngines``); 4 requests of 32 seeded images through
``Calculator(engine, batchsize=32).calcFromHost`` (``serve``).  The tests
run the same helpers on a narrow net.
"""

import time

import numpy as np


BATCH, REQUESTS = 32, 4
INSHAPE = (3, 224, 224)
CALIBRATION, CALIBRATION_BATCH, ALGO = 64, 16, "minmax"
DTYPES = ("int8", "bfloat16")


def buildNet():
    """VGG-16 at full width in f32, He weights from ``np.random.seed(0)``,
    without its SoftMax."""
    from puzzlelib_tpu_torch.models.nets import loadVGG

    np.random.seed(0)
    net = loadVGG(None, "16", initscheme="he")
    net.pop()
    return net


def images(count, inshape=INSHAPE, seed=1):
    """``count`` seeded f32 images (the served requests by default; the
    calibration set is ``images(CALIBRATION, seed=2)``)."""
    return np.random.RandomState(seed).randn(count, *inshape).astype(np.float32)


def buildEngines(net, savepath, calibration, batch=BATCH, dtypes=DTYPES, name="vgg16"):
    """Build one engine per type of ``dtypes`` for input (batch, *image) and
    return {dtype: engine path}; the int8 engine is calibrated on
    ``calibration``."""
    from puzzlelib_tpu_torch.converter.engine import DataCalibrator, buildEngine

    paths = {}
    for dtype in dtypes:
        calibrator = None
        if dtype == "int8":
            calibrator = DataCalibrator(calibration, batchsize=CALIBRATION_BATCH, algo=ALGO)

        paths[dtype] = buildEngine(net, inshape=(batch, ) + tuple(calibration.shape[1:]), savepath=savepath,
                                   dtype=dtype, name=name, calibrator=calibrator, returnEngine=False)

    return paths


def serve(module, data, batch=BATCH):
    """One timed ``calcFromHost`` of ``data`` through ``module`` (an
    ``Engine`` or a net): (output, seconds), host clock around work that ends
    in a device synchronize."""
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator

    synchronize()
    start = time.perf_counter()
    result = Calculator(module, batchsize=batch).calcFromHost(data)
    synchronize()
    return result, time.perf_counter() - start

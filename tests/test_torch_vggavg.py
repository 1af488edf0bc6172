"""``loadVGG(None, "16", poolmode="avg")`` at VGG-16's full size against
the JAX package: the forward of one 224 x 224 image in f32, in eval mode,
through the port's ``paramsFromNumpy`` of the JAX weights, held within
1e-5 of max(1, max |ref|), the reference's f32 tier.  (``tests/
test_torch_cnn.py`` holds VGG-11's features at 32 x 32 only.)"""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy
from puzzlelib_tpu_torch.models import nets as TNets


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def testVGG16AveragePoolingTwin():
    """The softmax output, the logits before it and the pooled features of
    conv5_3 (the last average pool's output) of the JAX package's
    ``loadVGG("16", poolmode="avg")`` at batch 1, 224 x 224, He weights
    from ``np.random.seed(0)``; five average pools and no max pool."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twin needs the JAX package")
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.nets.vgg import loadVGG

    np.random.seed(0)
    jnet = loadVGG(None, "16", poolmode="avg", initscheme="he")
    tnet = TNets.loadVGG(None, "16", poolmode="avg", initscheme="none")
    paramsFromNumpy(tnet, {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names})
    jnet.evalMode()
    tnet.evalMode()

    pools = [mod for mod in tnet.modules() if isinstance(mod, (T.AvgPool2D, T.MaxPool2D))]
    assert len(pools) == 5 and all(isinstance(pool, T.AvgPool2D) for pool in pools)

    x = np.random.RandomState(3).randn(1, 3, 224, 224).astype(np.float32)
    jout, tout = jnet(gpuarray.to_gpu(x)).get(), tnet(torch.from_numpy(x))

    for got, want in ((tout, jout), (tnet["pool5"].data, jnet.modules["pool5"].data.get()),
                      (tnet.graph[-2].data, jnet.modules[list(jnet.modules)[-2]].data.get())):
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * max(1.0, np.abs(want).max())

    assert tout.shape == (1, 1000) and abs(float(tout.sum()) - 1.0) < 1e-5

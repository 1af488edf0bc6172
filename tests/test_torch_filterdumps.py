"""The filter dumps of the port's ``cnnmnistlenet``, ``cnncifar10nin`` and
``cnncifar10simple`` (``dumpFilters``, through ``visual.py``) against the
root scripts' ``showFilters`` / ``showImageBasedFilters`` calls.

Each script's net and recipe is built in both packages from one numpy seed
(``test_torch_testlib``'s ``_jaxRun`` / ``_portRun``) and takes one
training step of 4 rows; then each package writes its PNGs.  The weights
of the two packages agree within the f32 tier, but a PNG cuts normalized
values to uint8, so a pixel moves one level wherever they straddle one:
the port's files are held within one level of the root scripts' (the same
files, sizes and modes), and the JAX package's weights written by the
port's ``dumpFilters`` give the root scripts' files pixel for pixel."""

import importlib

import numpy as np
import pytest

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch.convert import paramsFromNumpy

from test_torch_encodertrain import assertPngsClose, assertPngsEqual
from test_torch_testlib import _injectDropouts, _jaxRun, _portRun, _rows, _table


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _rootDumps(script, jnet, path):
    """The root script's dump calls on the JAX net: the file names."""
    from puzzlelib_tpu.visual import showFilters, showImageBasedFilters

    if script == "cnnmnistlenet":
        showFilters(jnet[0].W.get(), "%s/conv1.png" % path)
        showFilters(jnet[3].W.get(), "%s/conv2.png" % path)
        return ["conv1.png", "conv2.png"]

    if script == "cnncifar10nin":
        showImageBasedFilters(jnet["conv1"].W.get(), "%s/ninconv1.png" % path)
        showFilters(jnet["conv2"].W.get(), "%s/ninconv2.png" % path)
        showFilters(jnet["conv3"].W.get(), "%s/ninconv3.png" % path)
        return ["ninconv1.png", "ninconv2.png", "ninconv3.png"]

    for layer, dump in ((0, showImageBasedFilters), (3, showFilters), (6, showFilters)):
        dump(jnet[layer].W.get(), "%s/conv%d.png" % (path, layer // 3 + 1))
    return ["conv1.png", "conv2.png", "conv3.png"]


@pytest.mark.parametrize("script", ["cnnmnistlenet", "cnncifar10nin", "cnncifar10simple"])
def testFilterDumpsTwin(script, tmp_path):
    """One step of 4 rows of the script's recipe in both packages, then the
    root script's dumps and the port's ``dumpFilters``."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    module = importlib.import_module("puzzlelib_tpu_torch.testlib." + script)
    jnet, jtrainer = _jaxRun(script)
    tnet, ttrainer = _portRun(script)
    _injectDropouts(jnet, tnet)

    x, y = _rows(script, 4, seed=2)
    for trainer in (jtrainer, ttrainer):
        trainer.batchsize = 4
        np.random.seed(5)
        trainer.trainFromHost(x, y, macroBatchSize=len(x))

    for name in ("jax", "port", "fromjax"):
        (tmp_path / name).mkdir()

    files = _rootDumps(script, jnet, tmp_path / "jax")
    module.dumpFilters(tnet, str(tmp_path / "port"))

    fromJax = module.buildTraining()[0]
    paramsFromNumpy(fromJax, _table(jnet))
    module.dumpFilters(fromJax, str(tmp_path / "fromjax"))

    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(files)
    for fname in files:
        assertPngsClose(tmp_path / "port" / fname, tmp_path / "jax" / fname)
        assertPngsEqual(tmp_path / "fromjax" / fname, tmp_path / "jax" / fname)

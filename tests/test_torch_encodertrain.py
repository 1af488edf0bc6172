"""``puzzlelib_tpu_torch/testlib/encodertrain.py`` and ``normfilters.py``
against the root scripts, each ``main`` run in both packages on files the
test writes.

The tied autoencoder trains 5 epochs on small MNIST idx files
(``tools/dataslice.writeMnist``), its dropout on the same injected draws in
both packages: the weights within 1e-5 of max(1, max |ref|) of the JAX
package's (the f32 tier), the printed errors, and ``encoder.png``.  The
JAX package's ``MSE`` error is one f32 dot of the gradient with itself
over the batch's 78400 cells (``Blas.dot``), whose rounding on the CPU
reaches 1.2e-5 of the value against an f64 sum (the port's ``torch.sum``
stays within 1e-7): the printed errors are held to 4 sqrt(78400) 2^-24 =
6.7e-5 of the value, a recursive f32 sum of that length at four standard
deviations of its rounding.  The normalizations run on a seeded PNG:
both result PNGs.

A PNG of f32 values normalized to [0, 255] and cut to uint8 takes a pixel
one level up or down wherever the two packages' values, 1e-7 apart,
straddle a level; so the written files are held within one level of the
JAX package's, with the same size and mode, and the same weights or maps
written by the port give the JAX package's file pixel for pixel."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch import visual as TV
from puzzlelib_tpu_torch.convert import paramsToNumpy
from puzzlelib_tpu_torch.testlib import encodertrain as TEncoder
from puzzlelib_tpu_torch.testlib import normfilters as TNorm
from puzzlelib_tpu_torch.tools import dataslice as Data


BOUND = 1e-5
MSE_BOUND = 4.0 * np.sqrt(100 * 784) * 2.0 ** -24


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _jax(script):
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import importlib

    return importlib.import_module("testlib." + script)


def _pixels(path):
    from PIL import Image

    with Image.open(path) as img:
        return img.mode, np.asarray(img).astype(np.int16)


def assertPngsClose(got, want):
    """The same size and mode, each pixel within one level; returns the
    share of pixels that differ."""
    gotMode, gotPixels = _pixels(got)
    wantMode, wantPixels = _pixels(want)
    assert gotMode == wantMode and gotPixels.shape == wantPixels.shape
    assert np.abs(gotPixels - wantPixels).max() <= 1
    return float((gotPixels != wantPixels).mean())


def assertPngsEqual(got, want):
    gotMode, gotPixels = _pixels(got)
    wantMode, wantPixels = _pixels(want)
    assert gotMode == wantMode and np.array_equal(gotPixels, wantPixels)


def _injectDraws(monkeypatch, JDropout, seed=11):
    """Every dropout of either package draws the same seeded uint32 values,
    call by call, each package counting its own calls."""
    from puzzlelib_tpu.backend import gpuarray as jgpu

    def drawer(asTensor):
        calls = [0]

        def draw(self, size):
            calls[0] += 1
            rng = np.random.RandomState([seed, calls[0]])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        return draw

    monkeypatch.setattr(JDropout, "_drawRands", drawer(jgpu.to_gpu))
    monkeypatch.setattr(T.Dropout, "_drawRands", drawer(lambda ary: torch.from_numpy(ary.astype(np.int64))))


def testEncoderMainTwin(tmp_path, monkeypatch):
    """``main(epochs=5)`` of both packages on 150 + 50 MNIST images (2 steps
    an epoch of 100): the weights within the f32 tier, 5 printed errors
    each within ``MSE_BOUND``, falling;
    ``encoder.png`` (written after epoch 5) within one level, and the JAX
    weights' filters written by the port's ``showFilters`` equal to it."""
    JEncoder = _jax("encodertrain")
    from puzzlelib_tpu.modules import Dropout as JDropout

    _injectDraws(monkeypatch, JDropout)

    printed, nets = {}, {}
    for name, script in (("jax", JEncoder), ("port", TEncoder)):
        path = tmp_path / name
        path.mkdir()
        Data.writeMnist(str(path), train=150, test=50, seed=3)

        build = script.buildEncoder
        monkeypatch.setattr(script, "buildEncoder", lambda build=build, name=name: nets.setdefault(name, build()))

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            script.main(epochs=5, datapath=str(path))
        printed[name] = [float(v) for v in re.findall(r"Error: (\S+)", out.getvalue())]

    assert len(printed["port"]) == len(printed["jax"]) == 5
    assert np.allclose(printed["port"], printed["jax"], rtol=MSE_BOUND, atol=0.0), printed
    assert printed["port"][-1] < printed["port"][0]

    jtable = {name: np.asarray(var.data.get()) for var, names in nets["jax"].getVarTable().items() for name in names}
    ttable = paramsToNumpy(nets["port"])
    assert sorted(ttable) == sorted(jtable)
    for name, want in jtable.items():
        assert np.abs(ttable[name] - want).max() <= BOUND * max(1.0, np.abs(want).max()), name

    assertPngsClose(tmp_path / "port" / "encoder.png", tmp_path / "jax" / "encoder.png")

    jweights = np.asarray(nets["jax"][0].W.get()).T.reshape(16, 16, 28, 28)
    TV.showFilters(torch.from_numpy(np.ascontiguousarray(jweights)), str(tmp_path / "fromjax.png"))
    assertPngsEqual(tmp_path / "fromjax.png", tmp_path / "jax" / "encoder.png")


def testEncoderTiedWeightIsOneBlock():
    """The encoder's ``W`` and the decoder's are one block of the flat
    buffer (the same address, gradients too), and the dropout follows the
    relu that writes in place, as in the script."""
    np.random.seed(TEncoder.SEED)
    net = TEncoder.buildEncoder()
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    optimizer = MomentumSGD()
    optimizer.setupOn(net, useGlobalState=True)
    encoder, decoder = net[0].vars["W"], net[3].vars["W"]

    assert encoder.data.data_ptr() == decoder.data.data_ptr() and encoder.grad.data_ptr() == decoder.grad.data_ptr()
    assert sum(sh.ary.numel() for sh in optimizer.shParams.values()) == 784 * 256 + 256 + 784
    assert net[1].inplace and isinstance(net[2], T.Dropout)


def _writeImage(path, seed):
    from PIL import Image

    pixels = np.random.RandomState(seed).randint(0, 256, size=(48, 64, 3)).astype(np.uint8)
    Image.fromarray(pixels).save(path)


def testNormFiltersMainTwin(tmp_path):
    """``main`` of both packages on one seeded 48 x 64 RGB PNG:
    ``ResultSubtractNorm.png`` and ``ResultLCN.png`` within one level of
    the JAX package's, the two normalizations' maps within the f32 tier,
    and the JAX maps written by the port's ``showImage`` equal to the JAX
    package's files."""
    JNorm = _jax("normfilters")
    from puzzlelib_tpu.backend import gpuarray as jgpu
    from puzzlelib_tpu.modules import LCN as JLCN, SubtractMean as JSubtractMean
    from puzzlelib_tpu.visual import loadImage as jLoadImage

    image = str(tmp_path / "bench.png")
    _writeImage(image, seed=9)

    for name, script in (("jax", JNorm), ("port", TNorm)):
        (tmp_path / name).mkdir()
        script.main(imagepath=image, datapath=str(tmp_path / name))

    img = jLoadImage(image)
    jmaps = [JSubtractMean(size=7)(jgpu.to_gpu(img)).get(), JLCN(N=7)(jgpu.to_gpu(img)).get()]
    tmaps = TNorm.normalize(TV.loadImage(image))

    for fname, jmap, tmap in zip(("ResultSubtractNorm.png", "ResultLCN.png"), jmaps, tmaps):
        assert np.abs(tmap.numpy() - jmap).max() <= BOUND * max(1.0, np.abs(jmap).max())
        assertPngsClose(tmp_path / "port" / fname, tmp_path / "jax" / fname)

        TV.showImage(torch.from_numpy(np.array(jmap)), str(tmp_path / ("fromjax-" + fname)))
        assertPngsEqual(tmp_path / ("fromjax-" + fname), tmp_path / "jax" / fname)

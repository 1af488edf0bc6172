"""``puzzlelib_tpu_torch/visual.py`` against the JAX package's
``visual.py``: each function on the same arrays (and the port's on tensors
too), and on PNG files the tests write.  Loaded arrays and written files
must be equal, pixel for pixel; whitening within 1e-5 of max(1, max |ref|)
(the f32 tier).  The module imports without PIL, and its array functions
run without it."""

import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import visual as TV


BOUND = 1e-5


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    return importlib.import_module("puzzlelib_tpu.visual")


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    monkeypatch.setattr(TConfig, "device", "cpu")


def _pixels(path):
    from PIL import Image

    with Image.open(path) as img:
        return img.mode, np.asarray(img)


def _assertSameFile(got, want):
    gotMode, gotPixels = _pixels(got)
    wantMode, wantPixels = _pixels(want)
    assert gotMode == wantMode and gotPixels.shape == wantPixels.shape
    assert np.array_equal(gotPixels, wantPixels)


def _writePng(path, mode, shape, seed):
    from PIL import Image

    pixels = np.random.RandomState(seed).randint(0, 256, size=shape).astype(np.uint8)
    Image.fromarray(pixels, mode=mode).save(path)
    return pixels


IMAGES = {"RGB": (24, 32, 3), "RGBA": (20, 18, 4), "L": (16, 22)}


@pytest.mark.parametrize("mode", sorted(IMAGES))
@pytest.mark.parametrize("options", [dict(), dict(normalize=False), dict(mapsToFront=False),
                                     dict(shape=(12, 10)), dict(normalize=False, mapsToFront=False, contiguous=False)])
def testLoadImageTwin(tmp_path, mode, options):
    """``loadImage`` and ``loadImageFromBytes`` of RGB, RGBA (alpha dropped)
    and grayscale PNGs, resized or not, normalized or not, maps in front or
    last: the JAX package's arrays, bit for bit."""
    JV = _jax()
    path = str(tmp_path / "image.png")
    _writePng(path, mode, IMAGES[mode], seed=len(mode))

    got, want = TV.loadImage(path, **options), JV.loadImage(path, **options)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)

    with open(path, "rb") as f:
        raw = f.read()

    got = TV.loadImageFromBytes(raw, **options)
    assert np.array_equal(got, JV.loadImageFromBytes(raw, **options))


@pytest.mark.parametrize("kind", ["array", "tensor"])
def testNormalizeAndIntTwin(kind):
    """``normalizeImageInplace`` (in place, a flat image too) and
    ``imageToInt`` on arrays and on tensors: the JAX package's values."""
    JV = _jax()
    rng = np.random.RandomState(3)

    for ary in (rng.randn(3, 5, 7).astype(np.float32) * 4 + 1, np.full((2, 3), 0.5, np.float32)):
        want = ary.copy()
        JV.normalizeImageInplace(want)

        got = ary.copy() if kind == "array" else torch.from_numpy(ary.copy())
        TV.normalizeImageInplace(got)
        assert np.array_equal(np.asarray(got), want)

        ints = TV.imageToInt(got)
        assert np.array_equal(np.asarray(ints), JV.imageToInt(want))


@pytest.mark.parametrize("case", ["chw", "nchw", "gray", "noroll", "uint8", "tensor", "bf16"])
def testShowImageTwin(tmp_path, case):
    """``showImage`` of a float32 CHW image, a 4-d one, a grayscale one
    (also without ``rollMaps``), a uint8 image written as it is, and a
    tensor (f32, and bf16 read back as f32): the same PNG as the JAX
    package's."""
    JV = _jax()
    rng = np.random.RandomState(4)
    img = {"chw": rng.randn(3, 9, 11), "nchw": rng.randn(1, 3, 9, 11), "gray": rng.randn(1, 9, 11),
           "noroll": rng.randn(1, 9, 11), "uint8": rng.randint(0, 256, size=(9, 11, 3)),
           "tensor": rng.randn(3, 9, 11), "bf16": rng.randn(3, 9, 11)}[case]
    img = img.astype(np.uint8 if case == "uint8" else np.float32)
    rollMaps = case != "noroll"

    portImg = img
    if case == "tensor":
        portImg = torch.from_numpy(img)
    elif case == "bf16":
        portImg = torch.from_numpy(img).bfloat16()
        img = portImg.float().numpy()

    TV.showImage(portImg, str(tmp_path / "port.png"), rollMaps=rollMaps)
    JV.showImage(img, str(tmp_path / "jax.png"), rollMaps=rollMaps)
    _assertSameFile(tmp_path / "port.png", tmp_path / "jax.png")


def testShowImageBatchTwin(tmp_path):
    """``showImageBatch`` (a tensor batch, the extension given with its dot)
    and ``showImageBatchInFolder`` (the folder made): the same files."""
    JV = _jax()
    batch = np.random.RandomState(5).randn(3, 3, 8, 6).astype(np.float32)

    TV.showImageBatch(torch.from_numpy(batch), str(tmp_path / "port"), ext=".png")
    JV.showImageBatch(batch, str(tmp_path / "jax"), ext=".png")
    TV.showImageBatchInFolder(batch, str(tmp_path / "portdir"), "img")
    JV.showImageBatchInFolder(batch, str(tmp_path / "jaxdir"), "img")

    for i in range(1, 4):
        _assertSameFile(tmp_path / ("port-%d.png" % i), tmp_path / ("jax-%d.png" % i))
        _assertSameFile(tmp_path / "portdir" / ("img-%d.png" % i), tmp_path / "jaxdir" / ("img-%d.png" % i))


def testShowImageRefusesWhatTheJaxPackageRefuses(tmp_path):
    """More than one image, a batch of other than 4 axes, and maps left in
    front (PIL takes no (C, H, W) array): refused by both packages."""
    JV = _jax()
    for mod in (TV, JV):
        with pytest.raises(mod.VisualError):
            mod.showImage(np.zeros((2, 3, 4, 4), np.float32), str(tmp_path / "x.png"))
        with pytest.raises(mod.VisualError):
            mod.showImageBatch(np.zeros((3, 4, 4), np.float32), str(tmp_path / "x"))
        with pytest.raises(TypeError):
            mod.showImage(np.zeros((3, 4, 5), np.float32), str(tmp_path / "x.png"), rollMaps=False)


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 1, 3, 3), (2, 3, 4, 6)])
@pytest.mark.parametrize("normalize", [True, False])
def testShowFiltersTwin(tmp_path, shape, normalize):
    """``showFilters`` (each (out, in) plane a grayscale tile) and
    ``showImageBasedFilters`` (RGB tiles where a filter has 3 maps) of
    tensors and arrays, normalized or not (the raw weights then clipped by
    the uint8 cast, as in the JAX package): the same PNGs."""
    JV = _jax()
    filters = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32) * (1.0 if normalize else 0.9)

    TV.showFilters(torch.from_numpy(filters), str(tmp_path / "port.png"), normalize=normalize)
    JV.showFilters(filters, str(tmp_path / "jax.png"), normalize=normalize)
    _assertSameFile(tmp_path / "port.png", tmp_path / "jax.png")

    if shape[1] in (1, 3):
        TV.showImageBasedFilters(filters, str(tmp_path / "portimg.png"), cols=2, offset=2, normalize=normalize)
        JV.showImageBasedFilters(filters, str(tmp_path / "jaximg.png"), cols=2, offset=2, normalize=normalize)
        _assertSameFile(tmp_path / "portimg.png", tmp_path / "jaximg.png")


def testOneByOneFiltersAreNotWritten(tmp_path, capsys):
    """1 x 1 filters: a line printed and no file, in both packages."""
    JV = _jax()
    filters = np.ones((4, 3, 1, 1), np.float32)

    for mod, name in ((TV, "port"), (JV, "jax")):
        mod.showImageBasedFilters(filters, str(tmp_path / ("%s.png" % name)))
        assert not (tmp_path / ("%s.png" % name)).exists()

    out = capsys.readouterr().out
    assert out.count("Aborting showing 1x1 filters") == 2


@pytest.mark.parametrize("PCA", [False, True])
@pytest.mark.parametrize("kind", ["array", "tensor"])
def testWhitenTwin(PCA, kind):
    """``whiten`` (ZCA, and PCA) of a (64, 3, 4, 4) batch: within the f32
    tier of the JAX package's; an array's rows centered in place in both;
    a tensor's result a tensor of the input's shape."""
    JV = _jax()
    batch = np.random.RandomState(6).rand(64, 3, 4, 4).astype(np.float32)

    want, jaxBatch = JV.whiten(batch.copy(), PCA=PCA), batch.copy()
    JV.whiten(jaxBatch, PCA=PCA)

    if kind == "array":
        portBatch = batch.copy()
        got = TV.whiten(portBatch, PCA=PCA)
        assert np.array_equal(portBatch, jaxBatch)
    else:
        got = TV.whiten(torch.from_numpy(batch.copy()), PCA=PCA)
        assert isinstance(got, torch.Tensor)
        got = got.numpy()

    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BOUND * max(1.0, np.abs(want).max())


_NO_PIL = """
import sys
sys.modules["PIL"] = None
import numpy as np
import torch
from puzzlelib_tpu_torch import visual
img = torch.arange(12, dtype=torch.float32).reshape(3, 4)
visual.normalizeImageInplace(img)
assert float(img.max()) == 1.0 and visual.imageToInt(img).dtype == torch.uint8
assert visual.whiten(np.random.RandomState(0).rand(8, 4).astype(np.float32)).shape == (8, 4)
try:
    visual.showImage(np.zeros((4, 4), np.float32), "never.png")
except ImportError as e:
    print("REFUSED", "PIL" in str(e))
"""


def testImportsAndRunsArraysWithoutPil(tmp_path):
    """With PIL absent, as on the card's machine: the module imports, the
    array functions run, and writing an image raises an ImportError that
    names PIL."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _NO_PIL], cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "REFUSED True" in proc.stdout
    assert not (tmp_path / "never.png").exists()


def testImageToArrayOnAnOpenImage():
    """``imageToArray`` of an image opened by the caller."""
    JV = _jax()
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(7).randint(0, 256, size=(5, 6, 3)).astype(np.uint8)).save(buf, "PNG")
    img = Image.open(io.BytesIO(buf.getvalue()))
    assert np.array_equal(TV.imageToArray(img), JV.imageToArray(img))

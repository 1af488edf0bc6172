"""The contrast-normalization demo (the counterpart of
``testlib/normfilters.py``): ``SubtractMean(size=7)`` and ``LCN(N=7)`` over
one image, each result written back as a PNG.  Both modules take f32 only,
in both packages.  ``normalize`` runs them on an array; ``main`` reads and
writes the images through ``visual.py``, which needs PIL."""

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.modules import LCN, SubtractMean
from puzzlelib_tpu_torch.visual import loadImage, showImage

SIZE = 7


def normalize(img):
    """(SubtractMean's output, LCN's output) of ``img`` (1, C, H, W) f32,
    as tensors on the configured device."""
    subtractMean = SubtractMean(size=SIZE)
    lcn = LCN(N=SIZE)

    img = gpuarray.to_gpu(img)
    return subtractMean(img), lcn(img)


def main(imagepath="testdata/Bench.png", datapath="testdata/"):
    subtracted, normalized = normalize(loadImage(imagepath))

    showImage(subtracted, "%s/ResultSubtractNorm.png" % datapath)
    showImage(normalized, "%s/ResultLCN.png" % datapath)


if __name__ == "__main__":
    main()

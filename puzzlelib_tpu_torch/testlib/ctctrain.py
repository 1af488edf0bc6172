"""CTC training demo (the counterpart of ``testlib/ctctrain.py``): a
reduced Wave2Letter learns a synthetic alignment task.

Random label sequences (28 symbols and the blank) are rendered to
"acoustic" frames by a fixed random embedding, stretched 4x in time with
noise; the net (Wave2Letter's ``convBlock`` at 13 -> 128 -> 128 -> 256 ->
29) learns to undo the rendering under ``CTC(blank=0, vocabsize=29)`` and
``Adam(1e-3)`` in local state.  Its 1-d convs run on cuDNN on the card and
its CTC on the host loops of ``ops/ctc.py``: no hand kernel is on this path.

Run:  python -m puzzlelib_tpu_torch.testlib.ctctrain [steps]
Gate: the last step's NLL below 40 % of the first's.
"""

import sys
import time

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.memory import moveaxis
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import CTC
from puzzlelib_tpu_torch.models.nets.wavetoletter import convBlock
from puzzlelib_tpu_torch.modules import Conv1D
from puzzlelib_tpu_torch.optimizers import Adam

VOCAB = 29          # 28 symbols + blank
BLANK = 0
FEATS = 13          # MFCC-like input channels
LABLEN = 12         # labels per sample
STRETCH = 4         # frames per label
BATCH = 16
SEED = 7
GATE = 0.4


def makeBatch(rng, embed):
    """(frames (BATCH, FEATS, T) f32, labels concatenated int32, lengths
    int32) of one batch drawn from ``rng``."""
    labels = rng.randint(1, VOCAB, size=(BATCH, LABLEN)).astype(np.int32)

    frames = embed[labels]
    frames = np.repeat(frames, STRETCH, axis=1)
    frames += rng.randn(*frames.shape).astype(np.float32) * 0.1

    data = np.ascontiguousarray(frames.transpose(0, 2, 1))

    lengths = np.full((BATCH, ), LABLEN, dtype=np.int32)
    flat = labels.reshape(-1)
    return data, flat, lengths


def buildNet():
    net = Sequential(name="w2l-mini")
    net.extend(convBlock(FEATS, 128, 11, 2, 5, 0.0, "he", name="c1"))
    net.extend(convBlock(128, 128, 11, 1, 5, 0.0, "he", name="c2"))
    net.extend(convBlock(128, 256, 1, 1, 0, 0.0, "he", name="c3"))
    net.append(Conv1D(256, VOCAB, 1, useBias=True, initscheme="gaussian", wscale=0.01, name="out"))

    return net


def buildTraining():
    """(net, optimizer, cost, rng, embed): the net from ``np.random.seed(SEED)``
    and the batches' generator and embedding from ``RandomState(SEED)``."""
    rng = np.random.RandomState(SEED)
    embed = rng.randn(VOCAB, FEATS).astype(np.float32)

    np.random.seed(SEED)
    net = buildNet()

    optimizer = Adam(alpha=1e-3)
    optimizer.setupOn(net, useGlobalState=False)

    return net, optimizer, CTC(blank=BLANK, vocabsize=VOCAB), rng, embed


def step(net, optimizer, cost, data, datalen, labels, lengths):
    """One training step on a host batch: the batch's NLL over its size."""
    out = net(gpuarray.to_gpu(data))                                   # (B, VOCAB, T)

    error, grad = cost(
        (moveaxis(out, 2, 0), gpuarray.to_gpu(datalen)),                # CTC takes (T, B, V)
        (gpuarray.to_gpu(labels), gpuarray.to_gpu(lengths)),
    )

    netGrad = moveaxis(grad, 0, 2)                                     # back to (B, V, T)

    optimizer.zeroGradParams()
    net.backward(netGrad, updGrad=False)
    optimizer.update()
    net.reset()
    return float(error)


def main(steps=200):
    """``steps`` steps: (the first step's NLL, the last's, the seconds)."""
    net, optimizer, cost, rng, embed = buildTraining()

    T = LABLEN * STRETCH // 2                                          # conv stride 2
    datalen = np.full((BATCH, ), T, dtype=np.int32)

    first = error = None
    start = time.time()

    for i in range(1, steps + 1):
        data, labels, lengths = makeBatch(rng, embed)
        error = step(net, optimizer, cost, data, datalen, labels, lengths)

        if first is None:
            first = error

        if i % 10 == 0 or i == 1:
            print("step %3d: ctc nll %.4f (%.1fs)" % (i, error, time.time() - start), flush=True)

    secs = time.time() - start
    print("CTC nll %.4f -> %.4f (%.1f%%) in %.1fs" % (first, error, 100.0 * error / first, secs))
    assert error < GATE * first, "CTC did not learn: %.4f -> %.4f" % (first, error)
    return first, error, secs


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)

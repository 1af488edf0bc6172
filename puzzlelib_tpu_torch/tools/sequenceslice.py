"""The sequence slice, as ``chip_smoke.py`` and the tests run it.

The three IMDB sentiment nets of the JAX package's ``testlib`` scripts
(``rnnimdbtrain.py``, ``birnnimdbtrain.py``, ``cnnimdbtrain.py``), this
module's copies of their builders at their scripts' full width:

- "lstm": vocab 20000, 80 tokens, embedding 128, ``SwapAxes(0, 1)``, one
  LSTM of 128 (dropout 0.2, a no-op on one level), ``Linear(128, 1)``;
- "bilstm": vocab 20000, 100 tokens, embedding 128, a bidirectional LSTM
  of 64, ``Concat`` of the two halves, ``Dropout(0.5)``, ``Linear(128, 1)``;
- "cnn": vocab 5000, 250 tokens, embedding 50, ``Dropout(0.2)``,
  ``SwapAxes(1, 2)``, ``Conv1D(50, 50, 3)``, relu, ``MaxPool1D(248, 1)``,
  ``Flatten``, ``Linear(50, 250)``, ``Dropout(0.2)``, relu,
  ``Linear(250, 1)``.

Each trains in f32 at batch 32 (``_imdb.batchPlan`` without a batch hint)
with ``Adam(1e-3)`` in global state and ``BCE`` through
``Trainer.trainFromHost``, and validates through
``Validator.validateFromHost``, on a ``cnnslice.Run``: every ``train``
starts from the same weights, zero moments and the dropout generator's
seed, on route "hopper" (K1 takes the heads' ``Linear`` products
forward), "torch" (the library) or "fused" (``FusedTrainer`` /
``FusedValidator`` on the hand kernels).  The repo holds no IMDB file: the
token rows and labels are seeded (``data``).

Wave2Letter (``models/nets/wavetoletter.py``, ``loadW2L(None, inmaps=161,
nlabels=29)``, 106.8 M parameters) at full width in bf16, batch norms f32:
served through ``Calculator.calcFromHost`` (dropout off in eval mode) and
trained on the loop of the JAX package's ``testlib/ctctrain.py`` (forward,
``moveaxis`` to (T, B, 29), ``CTC(blank=0, vocabsize=29)``, the gradient
moved back and cast to the net's type, backward, ``Adam`` in global state)
by a ``W2LRun``.  Frames are seeded (8 x 161 x 1600 a batch; T = 800 after
the first block's stride), each sample 120 to 240 seeded labels from 1 to
28 (``w2lData``).

Weights come from ``np.random.seed(0)``.  The device is the caller's
``Config.device``.
"""

import time

import numpy as np

from puzzlelib_tpu_torch.tools import cnnslice as Cnn


BATCH = 32
STEPS = 4
VALIDATION = 128
ALPHA = 1e-3

NETS = ("lstm", "bilstm", "cnn")
WIDTHS = {"lstm": dict(numwords=20000, maxlen=80), "bilstm": dict(numwords=20000, maxlen=100),
          "cnn": dict(numwords=5000, maxlen=250, embsize=50)}

# K1's products a batch, forward: (name, M, K, N) of each net's Linear heads
GEMMS = {"lstm": [("lstm-head", BATCH, 128, 1)], "bilstm": [("bilstm-head", BATCH, 128, 1)],
         "cnn": [("cnn-fc1", BATCH, 50, 250), ("cnn-fc2", BATCH, 250, 1)]}

W2L_INMAPS, W2L_LABELS, W2L_BLANK = 161, 29, 0
W2L_BATCH, W2L_FRAMES, W2L_STEPS, W2L_REQUESTS = 8, 1600, 4, 4
W2L_LABEL_RANGE = (120, 240)
W2L_ALPHA = 1e-4


def buildLSTM(numwords=20000, maxlen=80, hintBatchsize=None):
    """``testlib/rnnimdbtrain.py``'s net."""
    from puzzlelib_tpu_torch.containers import Sequential
    from puzzlelib_tpu_torch.modules import Embedder, Linear, RNN, SwapAxes

    net = Sequential()
    net.append(Embedder(numwords, maxlen, 128, initscheme="uniform", wscale=0.05, learnable=True))
    net.append(SwapAxes(0, 1))
    net.append(RNN(128, 128, mode="lstm", dropout=0.2, hintBatchSize=hintBatchsize))
    net.append(Linear(128, 1))
    return net


def buildBiLSTM(numwords=20000, maxlen=100, hintBatchsize=None):
    """``testlib/birnnimdbtrain.py``'s net."""
    from puzzlelib_tpu_torch.containers import Sequential
    from puzzlelib_tpu_torch.modules import Concat, Dropout, Embedder, Linear, RNN, SwapAxes

    net = Sequential()
    net.append(Embedder(numwords, maxlen, 128, initscheme="uniform", wscale=0.05, learnable=True))
    net.append(SwapAxes(0, 1))
    net.append(RNN(128, 64, mode="lstm", direction="bi", hintBatchSize=hintBatchsize))
    net.append(Concat(axis=1))
    net.append(Dropout(p=0.5))
    net.append(Linear(128, 1))
    return net


def buildCNN(numwords=5000, maxlen=250, embsize=50):
    """``testlib/cnnimdbtrain.py``'s net."""
    from puzzlelib_tpu_torch.containers import Sequential
    from puzzlelib_tpu_torch.modules import (
        Activation, Conv1D, Dropout, Embedder, Flatten, Linear, MaxPool1D, SwapAxes, relu
    )

    net = Sequential()
    net.append(Embedder(numwords, maxlen, embsize, initscheme="uniform", wscale=0.05, learnable=True))
    net.append(Dropout(p=0.2))
    net.append(SwapAxes(1, 2))

    net.append(Conv1D(embsize, embsize, 3))
    net.append(Activation(relu))
    net.append(MaxPool1D(maxlen - 2, 1))
    net.append(Flatten())

    net.append(Linear(embsize, 250))
    net.append(Dropout(p=0.2))
    net.append(Activation(relu))
    net.append(Linear(250, 1))
    return net


BUILDERS = {"lstm": buildLSTM, "bilstm": buildBiLSTM, "cnn": buildCNN}


def build(kind, **widths):
    """``kind``'s net at ``WIDTHS[kind]`` (or ``widths``), weights from
    ``np.random.seed(0)``."""
    np.random.seed(0)
    return BUILDERS[kind](**(widths or WIDTHS[kind]))


def data(kind, count, seed=1, **widths):
    """``count`` seeded int32 token rows of ``kind``'s length and int32
    {0, 1} labels."""
    widths = widths or WIDTHS[kind]
    rng = np.random.RandomState(seed)

    tokens = rng.randint(0, widths["numwords"], size=(count, widths["maxlen"])).astype(np.int32)
    return tokens, rng.randint(0, 2, size=count).astype(np.int32)


def buildRun(kind, net=None, batch=BATCH):
    """A ``cnnslice.Run`` of ``net`` (default ``build(kind)``) in f32 with
    ``Adam(ALPHA)`` in global state and ``BCE``.  Clears
    ``Config.globalEvalMode``: training needs gradient buffers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.cost import BCE
    from puzzlelib_tpu_torch.optimizers import Adam

    Config.globalEvalMode = False
    net = build(kind) if net is None else net

    optimizer = Adam(alpha=ALPHA)
    optimizer.setupOn(net, useGlobalState=True)
    return Cnn.Run(net, optimizer, BCE(), batch)


# -- Wave2Letter -------------------------------------------------------------------------------

def w2lData(count, seed=3, frames=W2L_FRAMES, inmaps=W2L_INMAPS, labelRange=W2L_LABEL_RANGE):
    """``count`` seeded f32 frame sets (count, inmaps, frames), and per
    sample a run of labels from 1 to W2L_LABELS - 1 whose length lies in
    ``labelRange``: (frames, labels concatenated, lengths), int32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(count, inmaps, frames).astype(np.float32)

    lengths = rng.randint(labelRange[0], labelRange[1] + 1, size=count).astype(np.int32)
    labels = rng.randint(1, W2L_LABELS, size=int(lengths.sum())).astype(np.int32)
    return x, labels, lengths


def buildW2L(dtype=None):
    """Wave2Letter at full width, weights from ``np.random.seed(0)`` (the
    default scheme), in ``dtype`` (bf16 by default; the batch norms stay
    f32)."""
    import torch

    from puzzlelib_tpu_torch.models.nets import loadW2L

    np.random.seed(0)
    net = loadW2L(None, inmaps=W2L_INMAPS, nlabels=W2L_LABELS)
    net.calcMode(torch.bfloat16 if dtype is None else dtype)
    return net


class W2LRun:
    """A CTC-trained net on the loop of ``testlib/ctctrain.py`` with ``Adam``
    in global state, and its ``Calculator``: every ``train`` starts from the
    same weights, running stats, zero moments and the dropout generator's
    seed."""

    def __init__(self, net, alpha=W2L_ALPHA, batch=W2L_BATCH, blank=W2L_BLANK, nlabels=W2L_LABELS):
        from puzzlelib_tpu_torch import config as Config
        from puzzlelib_tpu_torch.cost import CTC
        from puzzlelib_tpu_torch.handlers import Calculator
        from puzzlelib_tpu_torch.optimizers import Adam

        Config.globalEvalMode = False
        self.net, self.batch = net, batch
        self.optimizer = Adam(alpha=alpha)
        self.optimizer.setupOn(net, useGlobalState=True)
        self.cost = CTC(blank=blank, vocabsize=nlabels)
        self.calculator = Calculator(net, batchsize=batch)

        self.start = {dtype: pack.ary.clone() for dtype, pack in self.optimizer.shParams.items()}
        self.startVars = []
        self.startAttrs = {name: attr.clone() for name, attr in net.getAttrTable().items()}
        self.startStates = Cnn._stateValues(self.optimizer)

    def restore(self):
        Cnn.Run.restore(self)

    def step(self, frames, datalen, labels, lengths):
        """One step of ``testlib/ctctrain.py``'s loop on device tensors:
        the batch's error (a 0-d tensor, no readback)."""
        from puzzlelib_tpu_torch.backend.memory import moveaxis

        out = self.net(frames)                                      # (B, V, T)
        self.cost((moveaxis(out, 2, 0), datalen), (labels, lengths), queryError=False)

        netGrad = moveaxis(self.cost.grad, 0, 2).to(out.dtype)      # back to (B, V, T)

        self.optimizer.zeroGradParams()
        self.net.backward(netGrad, updGrad=False)
        self.optimizer.update()
        self.net.reset()
        return self.cost.devErr

    def train(self, frames, labels, lengths, losses=None):
        """The steps over ``frames`` in batches, in order, from the start:
        seconds, host clock around work that ends in a device synchronize.
        Each step's error divided by the batch (``getError``) is appended to
        ``losses`` when it is given."""
        from puzzlelib_tpu_torch.backend import gpuarray
        from puzzlelib_tpu_torch.backend.device import synchronize

        self.restore()
        self.net.trainMode()
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        dtype = self.net.calctype

        synchronize()
        start = time.perf_counter()

        for i in range(0, len(frames), self.batch):
            x = gpuarray.to_gpu(frames[i:i + self.batch], dtype=dtype)
            lens = lengths[i:i + self.batch]
            outlen = self.net.dataShapeFrom(tuple(x.shape))[2]

            self.step(x, gpuarray.to_gpu(np.full(len(lens), outlen, dtype=np.int32)),
                      gpuarray.to_gpu(labels[offsets[i]:offsets[i + len(lens)]]), gpuarray.to_gpu(lens))

            if losses is not None:
                losses.append(self.cost.getError())

        synchronize()
        return time.perf_counter() - start

    def serve(self, frames):
        """One timed ``calcFromHost`` of the frames from the weights the net
        holds: (scores, seconds)."""
        from puzzlelib_tpu_torch.backend.device import synchronize

        synchronize()
        start = time.perf_counter()
        out = self.calculator.calcFromHost(frames, macroBatchSize=len(frames))
        synchronize()
        return out, time.perf_counter() - start

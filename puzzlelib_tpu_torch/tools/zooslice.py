"""The zoo slice, as ``chip_smoke.py`` and the tests run it.

Three serving nets of the zoo at full width, in bf16, served through
``Calculator.calcFromHost`` and ``FusedCalculator.calcFromHost`` with their
outputs as the loaders build them (a ``resnetslice.Served``):

- "miniyolo": ``loadMiniYolo(None, numOutput=1470)``, 448 x 448 x 3 in,
  1470 outputs (YOLO's 7 x 7 x 30 grid) after a SoftMax, batch 16;
- "coco": ``loadCOCO(None)``, OpenPose's usual 368 x 368 x 3 in, 57 maps
  of 46 x 46 out (38 part affinity fields, 19 part confidences), batch 8;
- "mpi": ``loadMPI(None)``, the same input, 71 maps of 46 x 46 out,
  batch 8.

On the card K2 takes the 3x3 stride-1 convs whose channels are multiples
of 128 (``winograd.applicable``): 12 of MiniYolo's 24 convs, 15 of OpenPose
COCO's and 12 of OpenPose MPI's (``winogradConvs`` names them from the
net), and K1 MiniYolo's ``fc25`` (50176 -> 512) and ``fc26`` on wgmma and
``fc27`` (N = 1470, off a multiple of 8) on the WMMA kernel.  The 7x7
convs, the 1x1 convs, MiniYolo's strided conv22 and the narrow stem convs
go to cuDNN.  Weights come from ``np.random.seed(0)``, He-scaled normals
for every conv and Linear and zero biases (``heTable``); images from a
numpy seed (the repo holds no COCO or VOC file).

SentiNet at its preset's widths (``presets.sentinet.buildTrainValidate``'s
defaults): a vocabulary of 20000 words (``vocabulary``), sentences of 100
words padded by 4 on each side with the padding word 0, embeddings of 300
(``wscale`` 0.25), branches of heights 3, 4 and 5 with 100 maps each and
2 classes, in f32.  ``sentiData`` seeds the sentences and labels, and
plants in each sentence 5 words of its label's lexicon of 100 (the repo
holds no IMDB or review corpus);
``SentiRun.preset`` splits and oversamples them as ``buildTrainValidate``
does and trains through ``presets.sentinet.train(..., saving=False)``
(``AdaDelta`` in local state, ``CrossEntropy``, ``Trainer`` at batch 64 and
``Validator``), reading its printed per-epoch errors back.  K1 takes the
``Linear(300, 2)`` head (f32).  ``SentiRun.optimizer(name)`` holds a
``cnnslice.Run`` of the same net under one of the six new optimizers with
the reference's defaults in global state, on the routes "hopper", "torch"
and "fused".  The device is the
caller's ``Config.device``.
"""

import contextlib
import io
import re

import numpy as np

from puzzlelib_tpu_torch.tools import cnnslice as Cnn
from puzzlelib_tpu_torch.tools import resnetslice as Res


NETS = ("miniyolo", "coco", "mpi")
NAMES = {"miniyolo": "MiniYolo", "coco": "OpenPose COCO", "mpi": "OpenPose MPI"}
SHAPES = {"miniyolo": (3, 448, 448), "coco": (3, 368, 368), "mpi": (3, 368, 368)}
BATCH = {"miniyolo": 16, "coco": 8, "mpi": 8}
REQUESTS = 4
YOLO_OUTPUTS = 1470

# K1's products a MiniYolo batch: (name, K, N)
YOLO_FC = [("fc25", 50176, 512), ("fc26", 512, 4096), ("fc27", 4096, YOLO_OUTPUTS)]

SENTI_VOCAB, SENTI_LENGTH, SENTI_PADDING, SENTI_EMBSIZE = 20000, 100, 4, 300
SENTI_BRANCHES, SENTI_MAPS, SENTI_CLASSES, SENTI_WSCALE = (3, 4, 5), 100, 2, 0.25
SENTI_ROWS, SENTI_BATCH, SENTI_EPOCHS, SENTI_STEPS = 2048, 64, 3, 4
SENTI_LEXICON = (100, 5)   # words a sentiment, words of it a sentence

# the six optimizers of the optimizer route, each with the reference's defaults
OPTIMIZERS = ("NesterovSGD", "AdaGrad", "AdaDelta", "RMSProp", "RMSPropGraves", "SMORMS3")


def data(kind, count, seed=1):
    """``count`` seeded f32 images of ``kind``'s shape."""
    return np.random.RandomState(seed).randn(count, *SHAPES[kind]).astype(np.float32)


def heTable(net):
    """A table of He-scaled normals for every weight of ``net`` (fan-in: a
    conv's input maps times its window, a Linear's input size) and zeros
    for every bias, drawn from numpy's stream in the order of the variables'
    names."""
    table = {}
    for name, var in sorted((names[0], var) for var, names in net.getVarTable().items()):
        shape = tuple(var.data.shape)
        if name.endswith(".b") or name == "b":
            table[name] = np.zeros(shape, np.float32)
        else:
            fanIn = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            table[name] = (np.random.randn(*shape) * np.sqrt(2.0 / fanIn)).astype(np.float32)

    return table


def build(kind):
    """``kind``'s net with its output modules, in eval mode (serving needs
    no gradient buffers), He weights from ``np.random.seed(0)``."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy
    from puzzlelib_tpu_torch.models.nets import loadCOCO, loadMiniYolo, loadMPI

    evalMode, Config.globalEvalMode = Config.globalEvalMode, True
    try:
        net = {"miniyolo": lambda: loadMiniYolo(None, numOutput=YOLO_OUTPUTS), "coco": lambda: loadCOCO(None),
               "mpi": lambda: loadMPI(None)}[kind]()
    finally:
        Config.globalEvalMode = evalMode

    np.random.seed(0)
    paramsFromNumpy(net, heTable(net))
    return net


def buildRun(kind, net=None, dtype=None):
    """``resnetslice.Served`` of ``net`` (default ``build(kind)``) in
    ``dtype`` (bf16 by default) at ``kind``'s batch."""
    import torch

    net = build(kind) if net is None else net
    net.calcMode(torch.bfloat16 if dtype is None else dtype)
    return Res.Served(net, BATCH[kind])


def winogradConvs(net, kind):
    """The names of ``kind``'s convs that K2 takes at its batch and shape."""
    return Res.winogradConvs(net, (BATCH[kind], ) + SHAPES[kind])


def kernelConvs(net, kind):
    """K2's convs of ``net`` grouped by shape, for ``chip_smoke._convKernels``:
    [(space-separated names, x shape at batch 1, output maps)]."""
    groups, names = {}, winogradConvs(net, kind)
    for conv, shape in Res.convInputs(net, (1, ) + SHAPES[kind]):
        if conv.name in names:
            groups.setdefault((tuple(shape[1:]), conv.W.shape[0]), []).append(conv.name)

    return [(" ".join(names), inshape, co) for (inshape, co), names in groups.items()]


# -- SentiNet ------------------------------------------------------------------------------------

def vocabulary(size=SENTI_VOCAB):
    """A vocabulary of ``size`` words, word 0 the padding."""
    return {"w%d" % i: i for i in range(size)}


def sentiData(count=SENTI_ROWS, seed=1, vocab=SENTI_VOCAB, length=SENTI_LENGTH, padding=SENTI_PADDING,
              lexicon=SENTI_LEXICON):
    """``count`` seeded int32 sentences of ``length`` words from 1 to vocab -
    1, padded with word 0 by ``padding`` on each side, and int32 {0, 1}
    labels.  A sentiment to learn: each sentence holds ``lexicon[1]`` words
    drawn from its label's lexicon of ``lexicon[0]`` words (words 1 on for
    label 0, the next ``lexicon[0]`` for label 1) at seeded places."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, SENTI_CLASSES, size=count).astype(np.int32)
    words = rng.randint(1, vocab, size=(count, length))

    size, marks = lexicon
    places = np.argsort(rng.rand(count, length), axis=1)[:, :marks]
    np.put_along_axis(words, places, 1 + labels[:, None] * size + rng.randint(0, size, size=(count, marks)), axis=1)

    tokens = np.zeros((count, length + 2 * padding), np.int32)
    tokens[:, padding:padding + length] = words
    return tokens, labels


def buildSentiNet(vocab=SENTI_VOCAB, length=SENTI_LENGTH, padding=SENTI_PADDING, embsize=SENTI_EMBSIZE,
                  maps=SENTI_MAPS):
    """SentiNet as ``buildTrainValidate`` builds it, weights from
    ``np.random.seed(0)``, in f32, with gradient buffers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.models.nets.sentinet import buildNet

    Config.globalEvalMode = False
    np.random.seed(0)
    net = buildNet(vocabulary(vocab), SENTI_BRANCHES, None, length + 2 * padding, embsize, SENTI_WSCALE,
                   dim=SENTI_CLASSES, branchMaps=maps)
    net.setAttr("sentlength", length)
    net.setAttr("padding", padding)
    return net


_EPOCH_LINE = re.compile(r"Train error: (\S+)\. Val error: (\S+)")


class SentiRun:
    """SentiNet and its start weights: ``preset`` trains it through the
    preset from them, ``optimizer`` builds a ``cnnslice.Run`` of it under
    one of ``OPTIMIZERS`` in global state, ``serve`` runs a
    ``Calculator``."""

    def __init__(self, net=None, batch=SENTI_BATCH):
        from puzzlelib_tpu_torch.convert import paramsToNumpy

        self.net = buildSentiNet() if net is None else net
        self.batch = batch
        self.start = {name: ary.copy() for name, ary in paramsToNumpy(self.net).items()}   # no views on the CPU

    def restore(self):
        from puzzlelib_tpu_torch.convert import paramsFromNumpy
        from puzzlelib_tpu_torch.rng import globalRng

        paramsFromNumpy(self.net, self.start)
        globalRng.seed(Cnn.DROPOUT_SEED)

    def preset(self, algo, tokens, labels, epochs=SENTI_EPOCHS):
        """``presets.sentinet.train(..., saving=False)`` on ``algo``'s route
        from the start weights, the data split and oversampled as
        ``buildTrainValidate`` does from ``np.random.seed(0)``: the epochs'
        mean training errors (``trainErrors``) and validation errors
        (``valErrors``), the best ``accuracy``, the ``seconds`` and the rows
        trained and validated an epoch (``trainRows``, ``valRows``)."""
        import time
        import types

        from puzzlelib_tpu_torch.backend.device import synchronize
        from puzzlelib_tpu_torch.datasets.utils import replicateData, splitData
        from puzzlelib_tpu_torch.models.nets.presets import sentinet as preset

        Cnn._route(algo)
        self.restore()
        np.random.seed(0)
        trainData, valData, trainLabels, valLabels = splitData(tokens.copy(), labels.copy(), validation=0.1,
                                                               dim=SENTI_CLASSES)
        trainData, trainLabels = replicateData(trainData, trainLabels, dim=SENTI_CLASSES)

        printed = io.StringIO()
        synchronize()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            _, accuracy = preset.train(self.net, trainData, trainLabels, valData, valLabels, SENTI_CLASSES,
                                       epochs=epochs, saving=False)
        synchronize()
        secs = time.perf_counter() - start

        epochsRead = [tuple(float(v) for v in m.groups()) for m in _EPOCH_LINE.finditer(printed.getvalue())]
        return types.SimpleNamespace(trainErrors=[e[0] for e in epochsRead], valErrors=[e[1] for e in epochsRead],
                                     accuracy=accuracy, seconds=secs, trainRows=len(trainData), valRows=len(valData))

    def optimizer(self, name):
        """A ``cnnslice.Run`` of the net from the start weights under
        ``name`` (of ``OPTIMIZERS``) in global state with ``CrossEntropy``:
        every ``train`` starts from the same weights and optimizer state."""
        from puzzlelib_tpu_torch import optimizers
        from puzzlelib_tpu_torch.cost import CrossEntropy

        self.restore()
        opt = getattr(optimizers, name)()
        opt.setupOn(self.net, useGlobalState=True)
        return Cnn.Run(self.net, opt, CrossEntropy(maxlabels=SENTI_CLASSES), self.batch)

    def serve(self, tokens):
        """One timed ``calcFromHost`` of ``tokens`` from the weights the net
        holds: (scores, seconds)."""
        import time

        from puzzlelib_tpu_torch.backend.device import synchronize
        from puzzlelib_tpu_torch.handlers import Calculator

        synchronize()
        start = time.perf_counter()
        out = Calculator(self.net, batchsize=self.batch).calcFromHost(tokens, macroBatchSize=len(tokens))
        synchronize()
        return out, time.perf_counter() - start

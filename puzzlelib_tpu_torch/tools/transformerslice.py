"""The transformer slices, serving and training, as ``chip_smoke.py`` and
``tools/profiletransformer.py`` run them.

The IMDB transformer classifier of ``testlib/transformertrain.py`` at full
width (vocab 20000, seq 80, emb 128, 4 heads of 32, 2 layers, MLP ratio 4, 2
classes), weights from ``np.random.seed(0)``, on two routes that share the
weights: the hand kernels (``attnAlgo="flash"``, ``Config.gemmAlgo =
"hopper"``) and the library route (``attnAlgo="xla"``, ``"torch"``).

- Serving: 4 requests of 64 seeded int32 token rows through
  ``Calculator(net, batchsize=64).calcFromHost`` (``build``, ``serve``).
- Training: both nets in bf16 with ``Adam(alpha=1e-3)`` in global state and
  ``CrossEntropy(maxlabels=2)``, 4 steps of 64 over 256 seeded token rows
  and labels through ``Trainer(batchsize=64).trainFromHost``
  (``buildTraining``, ``train``); every run starts from the same weights
  and a fresh optimizer state.

Each slice also has the fused route of the JAX package's scripts, on the
hand kernels and the hand route's net: serving through
``FusedCalculator(batchsize=64)`` (``fusedCalculator``, route "fused"),
training through ``FusedTrainer(batchsize=64, stepsPerDispatch=4)`` as
``testlib/transformertrain.py`` trains (route "fused"), and with
``stepsPerDispatch=1`` (route "fused-1"), which steps batch by batch as the
eager ``Trainer`` does.
"""

import time

import numpy as np


CONFIG = dict(vocabsize=20000, seqlen=80, embsize=128, nheads=4, nlayers=2, nclasses=2)
BATCH, REQUESTS = 64, 4
STEPS, ALPHA = 4, 1e-3
STEPS_PER_DISPATCH = 4
FUSED = "fused"

# K1's products per request, (name, M, K, N, launches): each block's two MLP
# layers on the batch's rows, and the head's classifier
GEMMS = [
    ("mlp-up", BATCH * CONFIG["seqlen"], CONFIG["embsize"], 4 * CONFIG["embsize"], CONFIG["nlayers"]),
    ("mlp-down", BATCH * CONFIG["seqlen"], 4 * CONFIG["embsize"], CONFIG["embsize"], CONFIG["nlayers"]),
    ("head", BATCH, CONFIG["embsize"], CONFIG["nclasses"], 1),
]


def build():
    """({"hopper": net, "torch": net} in f32 with the same weights, the token
    rows).  Sets ``Config.device = "cuda"`` and ``globalEvalMode``: a
    serving net needs no gradient buffers."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
    from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier

    Config.device = "cuda"
    Config.globalEvalMode = True

    np.random.seed(0)
    hand = buildTransformerClassifier(**CONFIG, attnAlgo="flash", name="imdb-transformer")
    lib = buildTransformerClassifier(**CONFIG, attnAlgo="xla", name="imdb-transformer")
    paramsFromNumpy(lib, paramsToNumpy(hand))

    tokens = np.random.RandomState(1).randint(0, CONFIG["vocabsize"], size=(BATCH * REQUESTS, CONFIG["seqlen"]))
    return {"hopper": hand, "torch": lib}, tokens.astype(np.int32)


def fusedCalculator(routes):
    """The fused serving route: a ``FusedCalculator`` of the hand route's
    net, kept under ``routes["fused"]`` so that its recordings last across
    requests."""
    from puzzlelib_tpu_torch.fused import FusedCalculator

    return FusedCalculator(routes["hopper"], batchsize=BATCH)


def serve(routes, algo, tokens):
    """One timed ``calcFromHost`` of the token rows on a route: (logits,
    seconds), host clock around work that ends in a device synchronize.
    Route "fused" is ``routes["fused"]``, a ``fusedCalculator``, on the
    hand kernels."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator

    Config.gemmAlgo = "hopper" if algo == FUSED else algo
    calculator = routes[FUSED] if algo == FUSED else Calculator(routes[algo], batchsize=BATCH)

    synchronize()
    start = time.perf_counter()
    result = calculator.calcFromHost(tokens)
    synchronize()
    return result, time.perf_counter() - start


class Route:
    """One training route: its net, optimizer and trainer, the algo its
    kernels take ("hopper" or "torch") and the start values of the
    optimizer's flat parameter buffers."""

    def __init__(self, net, optimizer, trainer, algo):
        self.net, self.optimizer, self.trainer, self.algo = net, optimizer, trainer, algo
        self.start = {dtype: pack.ary.clone() for dtype, pack in optimizer.shParams.items()}

    def restore(self):
        """The start weights, zero Adam moments and step count."""
        for dtype, pack in self.optimizer.shParams.items():
            pack.ary.copy_(self.start[dtype])

        for state in self.optimizer.states.values():
            for tensor in state.values():
                tensor.zero_()

        self.optimizer.t = 0


def buildTraining(rows=BATCH * STEPS):
    """({"hopper": Route, "torch": Route, "fused": Route, "fused-1": Route}
    in bf16 with the same start weights, ``rows`` token rows, labels).  The
    fused routes train the hand route's net with its optimizer, through
    ``FusedTrainer`` with ``STEPS_PER_DISPATCH`` and 1 steps a dispatch.
    Sets ``Config.device = "cuda"`` and clears ``globalEvalMode``: a
    training net needs gradient buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.fused import FusedTrainer
    from puzzlelib_tpu_torch.handlers import Trainer
    from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier
    from puzzlelib_tpu_torch.optimizers import Adam

    Config.device = "cuda"
    Config.globalEvalMode = False

    np.random.seed(0)
    hand = buildTransformerClassifier(**CONFIG, attnAlgo="flash", name="imdb-transformer")
    lib = buildTransformerClassifier(**CONFIG, attnAlgo="xla", name="imdb-transformer")
    paramsFromNumpy(lib, paramsToNumpy(hand))

    routes = {}
    for algo, net in (("hopper", hand), ("torch", lib)):
        net.calcMode(torch.bfloat16)
        optimizer = Adam(alpha=ALPHA)
        optimizer.setupOn(net, useGlobalState=True)
        trainer = Trainer(net, CrossEntropy(maxlabels=CONFIG["nclasses"]), optimizer, batchsize=BATCH)
        routes[algo] = Route(net, optimizer, trainer, algo)

    hand = routes["hopper"]
    for name, perDispatch in ((FUSED, STEPS_PER_DISPATCH), (FUSED + "-1", 1)):
        trainer = FusedTrainer(hand.net, CrossEntropy(maxlabels=CONFIG["nclasses"]), hand.optimizer, batchsize=BATCH,
                               stepsPerDispatch=perDispatch)
        routes[name] = Route(hand.net, hand.optimizer, trainer, "hopper")

    tokens = np.random.RandomState(1).randint(0, CONFIG["vocabsize"], size=(rows, CONFIG["seqlen"]))
    labels = np.random.RandomState(2).randint(0, CONFIG["nclasses"], size=rows)
    return routes, tokens.astype(np.int32), labels.astype(np.int32)


def train(routes, algo, tokens, labels, losses=None):
    """One timed ``trainFromHost`` of all the rows on a route from the start
    weights, shuffled by one numpy seed: seconds, host clock around work
    that ends in a device synchronize.  Each step's loss is appended to
    ``losses`` when it is given (a per-batch callback: route "fused" then
    steps batch by batch, as ``FusedTrainer`` does under a callback)."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize

    route = routes[algo]
    route.restore()
    route.trainer.onBatchFinish = None if losses is None else (lambda h: losses.append(h.cost.getError()))
    Config.gemmAlgo = route.algo

    np.random.seed(4)
    synchronize()
    start = time.perf_counter()
    route.trainer.trainFromHost(tokens, labels, macroBatchSize=len(tokens))
    synchronize()
    return time.perf_counter() - start

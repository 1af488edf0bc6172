"""The transformer serving slice, as ``chip_smoke.py`` and
``tools/profiletransformer.py`` both run it.

The IMDB transformer classifier of ``testlib/transformertrain.py`` at full
width (vocab 20000, seq 80, emb 128, 4 heads of 32, 2 layers, MLP ratio 4, 2
classes), weights from ``np.random.seed(0)``, 4 requests of 64 seeded int32
token rows through ``Calculator(net, batchsize=64).calcFromHost``, on two
routes that share the weights: the hand kernels (``attnAlgo="flash"``,
``Config.gemmAlgo = "hopper"``) and the library route (``attnAlgo="xla"``,
``"torch"``).
"""

import time

import numpy as np


CONFIG = dict(vocabsize=20000, seqlen=80, embsize=128, nheads=4, nlayers=2, nclasses=2)
BATCH, REQUESTS = 64, 4

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


def serve(routes, algo, tokens):
    """One timed ``calcFromHost`` of the token rows on a route: (logits,
    seconds), host clock around work that ends in a device synchronize."""
    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.backend.device import synchronize
    from puzzlelib_tpu_torch.handlers import Calculator

    Config.gemmAlgo = algo
    synchronize()
    start = time.perf_counter()
    result = Calculator(routes[algo], batchsize=BATCH).calcFromHost(tokens)
    synchronize()
    return result, time.perf_counter() - start

"""Where the time of the serving engines goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profileengine

Builds the int8 and bf16 VGG-16 engines of ``tools/engineslice.py`` on the
card, serves the slice's 4 requests of 32 images through each, and through
the eager bf16 net (a clone made through the net's blueprint, as the bf16
engine traces one: ``buildengine.halfClone``), once to warm up
and once under ``torch.profiler``, and prints for each run the wall time of
the profiled run, the device's busy time (the union of the kernel and copy
intervals), the idle share, and the device time by kernel name.
``chip_smoke.py`` [engine-int8] and [engine-bf16] give the engines'
throughput outside the profiler, [K1-int8] the kernel's times.
"""

import tempfile

import torch

from puzzlelib_tpu_torch.tools import engineslice as Engines
from puzzlelib_tpu_torch.tools.profiletransformer import _profile
from puzzlelib_tpu_torch.tools.timing import cardName


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.converter.engine import Engine
    from puzzlelib_tpu_torch.converter.engine.buildengine import halfClone
    from puzzlelib_tpu_torch.ops.hopper import build

    print(cardName())

    Config.device = "cuda"
    Config.globalEvalMode = True

    net = Engines.buildNet()
    requests = Engines.images(Engines.BATCH * Engines.REQUESTS)

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as workdir:
        paths = Engines.buildEngines(net, workdir, Engines.images(Engines.CALIBRATION, seed=2))
        modules = {"int8 engine": Engine(paths["int8"]), "bf16 engine": Engine(paths["bfloat16"])}

    clone = halfClone(net, torch.bfloat16)
    modules["eager bf16 net"] = clone
    del net

    for label, module in modules.items():
        Engines.serve(module, requests)
        _profile(lambda: Engines.serve(module, requests)[1], label)


if __name__ == "__main__":
    main()

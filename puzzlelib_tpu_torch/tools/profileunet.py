"""Where the device time of the U-Net slice goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 -m puzzlelib_tpu_torch.tools.profileunet

Builds the run of ``tools/unetslice.py`` (U-Net in bf16 at batch 4 on 512 x
512 inputs, ``MomentumSGD`` in global state, ``BCE``) and, on the hand
route, the fused route and the library route, serves 4 requests of 4 and
trains 4 steps of 4, each once to warm up and once under
``torch.profiler``; prints for each run what ``profileresnet`` prints: the
wall time, the device's busy time, the idle share, the device time by
kernel name, and the device time of the hand kernels, of PyTorch's
elementwise and reduction kernels (the activations, the concats, the
casts) and of the rest (cuDNN's convs and deconvs, copies).
``chip_smoke.py`` [unet] gives the routes' throughput outside the profiler
and the kernels' times at these shapes.
"""

import torch

from puzzlelib_tpu_torch.tools import unetslice as Unet
from puzzlelib_tpu_torch.tools.profileresnet import STEPS, profileRoutes
from puzzlelib_tpu_torch.tools.timing import cardName


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile needs an NVIDIA GPU")

    from puzzlelib_tpu_torch import config as Config

    print(cardName())
    Config.device = "cuda"
    profileRoutes(Unet.buildRun(), *Unet.data(Unet.BATCH * STEPS), "U-Net", Unet.BATCH)


if __name__ == "__main__":
    main()

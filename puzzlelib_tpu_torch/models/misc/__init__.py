"""Models outside the zoo of nets (counterpart of
``puzzlelib_tpu/models/misc``)."""

from puzzlelib_tpu_torch.models.misc.rbm import RBM

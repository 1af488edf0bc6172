"""Graph passes (counterpart of ``puzzlelib_tpu/passes``)."""

from puzzlelib_tpu_torch.passes.converttograph import toGraph, ConverterError

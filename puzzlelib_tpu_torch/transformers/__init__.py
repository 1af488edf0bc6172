"""Threaded data pipeline (copies of ``puzzlelib_tpu/transformers``): a
provider hands out chunks of host data, each run through its transformers
on a pool of threads while the card trains on the chunk before."""

from puzzlelib_tpu_torch.transformers.provider import Provider
from puzzlelib_tpu_torch.transformers.transformer import Transformer
from puzzlelib_tpu_torch.transformers.serial import Serial
from puzzlelib_tpu_torch.transformers.merger import Merger
from puzzlelib_tpu_torch.transformers.generator import Generator

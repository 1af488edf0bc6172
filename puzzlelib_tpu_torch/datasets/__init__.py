"""Dataset loaders (copies of ``puzzlelib_tpu/datasets``): each parses a
dataset's raw files once and keeps the arrays in an HDF5 cache.  The cache
needs ``h5py``, imported only where a cache is opened, so the package
imports without it; ``MnistLoader``, ``Cifar10Loader`` and ``IMDBLoader``
also parse without it (``_parse``).  ``utils`` holds the split, replicate
and validation helpers."""

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader
from puzzlelib_tpu_torch.datasets.mnistloader import MnistLoader
from puzzlelib_tpu_torch.datasets.cifar10loader import Cifar10Loader
from puzzlelib_tpu_torch.datasets.imdbloader import IMDBLoader
from puzzlelib_tpu_torch.datasets.smallnorbloader import SmallNorbLoader
from puzzlelib_tpu_torch.datasets.inputloader import InputLoader
from puzzlelib_tpu_torch.datasets.pathloader import PathLoader
from puzzlelib_tpu_torch.datasets.tarloader import TarLoader
from puzzlelib_tpu_torch.datasets.ziploader import ZipLoader

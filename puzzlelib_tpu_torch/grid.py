"""Top-level grid alias (the reference's import path, ``from PuzzleLib.Grid
import runGrid``), as ``puzzlelib_tpu/grid.py`` is."""

from puzzlelib_tpu_torch.parallel.grid import runGrid, NodeInfo, GridError

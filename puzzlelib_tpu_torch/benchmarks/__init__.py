"""Benchmark harnesses of the port (counterpart of ``puzzlelib_tpu/benchmarks``):
``gemmspeed``, ``convspeed`` and ``attnspeed``, each a command-line script
(``python3 -m puzzlelib_tpu_torch.benchmarks.<name>``) that times the hand
kernels against the library's call on the card, or on the CPU with
``--device cpu`` at small sizes; and ``netspeed``, a whole zoo net's train
or infer throughput.  The reference's ``enableCompileCache``
serves XLA's compile cache and has no counterpart: the port's cache is the
kernel build's (``ops/hopper/build.py``)."""

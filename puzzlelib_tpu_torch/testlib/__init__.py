"""Counterparts of the JAX package's ``testlib`` training scripts: each
keeps its script's file name and ``main`` signature, and takes its net from
where the port already builds it (``tools/cnnslice.py``,
``tools/sequenceslice.py``) or builds it as the script does.  Where a
script loads its data (a dataset loader, scikit-learn's digits, an image),
``main`` is "load, then train": a function of the counterpart takes the
arrays, so that the card, which has no ``h5py``, scikit-learn or PIL, runs
the training on arrays of its own.  The filter and image dumps go through
``puzzlelib_tpu_torch/visual.py``, which imports PIL only to write."""

"""Counterparts of the JAX package's ``testlib`` training scripts that
start from a dataset loader: each keeps its script's file name and
``main(epochs, datapath)``, and takes its net from where the port already
builds it (``tools/cnnslice.py``, ``tools/sequenceslice.py``).  The root
scripts' filter dumps (``showFilters`` / ``showImageBasedFilters`` of
``visual.py``) are left out: ``visual.py`` has no port yet."""

"""Device, transfers and the dispatch of BLAS and DNN primitives."""

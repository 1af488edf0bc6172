"""Converters (counterpart of ``puzzlelib_tpu/converter``).  Ported so far:
the deployment engine (``converter.engine``: ``buildEngine``, ``Engine``,
``DataCalibrator``) and the RNN weight layouts (``converter.rnnweights``:
``cudnnRnnLayout``, ``convertRnnWeights``).  The ONNX exporter, the Caffe
and MXNet importers and ``convertRnnCheckpoint`` come later."""

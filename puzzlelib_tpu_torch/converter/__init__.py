"""Converters (counterpart of ``puzzlelib_tpu/converter``).  Ported so far:
the deployment engine (``converter.engine``: ``buildEngine``, ``Engine``,
``DataCalibrator``) and the RNN weight layouts (``converter.rnnweights``:
``cudnnRnnLayout``, ``convertRnnWeights``, ``convertRnnCheckpoint``).  The
ONNX exporter and the Caffe and MXNet importers come later."""

"""Converters (counterpart of ``puzzlelib_tpu/converter``).  Ported so far:
the deployment engine (``converter.engine``: ``buildEngine``, ``Engine``,
``DataCalibrator``).  The ONNX exporter and the Caffe and MXNet importers
come later."""

"""Converters (counterpart of ``puzzlelib_tpu/converter``): the deployment
engine (``converter.engine``: ``buildEngine``, ``Engine``,
``DataCalibrator``), the RNN weight layouts (``converter.rnnweights``:
``cudnnRnnLayout``, ``convertRnnWeights``, ``convertRnnCheckpoint``), the
ONNX exporter (``converter.onnx``: ``ONNXExporter``, with the wire codec
``protowire`` and the IR subset ``onnxmodel``) and the weight importers
(``converter.caffe``: ``loadNetParameter``, ``js2hdf``, ``convert``;
``converter.mxnet``: ``readHeader``, ``readData``, ``readKeys``,
``buildHdf``, ``convert``), which write the checkpoint layout the zoo's
loaders read.  None imports ``h5py`` but to open a path.  The C++ serving
driver is ``converter/engine/src``."""

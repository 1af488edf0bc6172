from puzzlelib_tpu_torch.converter.mxnet.convertmodel import convert, readHeader, readData, readKeys, buildHdf

from puzzlelib_tpu_torch.converter.caffe.convertmodel import convert, loadNetParameter, js2hdf

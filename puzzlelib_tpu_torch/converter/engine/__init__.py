from puzzlelib_tpu_torch.converter.engine.buildengine import buildEngine, DataType
from puzzlelib_tpu_torch.converter.engine.engine import Engine
from puzzlelib_tpu_torch.converter.engine.datacalibrator import DataCalibrator

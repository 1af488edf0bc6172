"""Single-dataset circular chunk provider (a copy of
``puzzlelib_tpu/transformers/serial.py``): walks the dataset in fixed-size
chunks, wrapping around at the end so epochs stream seamlessly.
"""

import numpy as np

from puzzlelib_tpu_torch.transformers.provider import Provider


def _wrapRead(source, begin, count, total):
    """Read ``count`` rows starting at ``begin``, wrapping past ``total``."""
    head = min(count, total - begin)
    out = np.empty((count, ) + source.shape[1:], dtype=source.dtype)

    out[:head] = source[begin:begin + head]
    if head < count:
        out[head:] = source[:count - head]

    return out


class Serial(Provider):
    def __init__(self, dataset, labels=None, numofthreads=4):
        super().__init__(numofthreads)

        self.dataset, self.labels = dataset, labels
        self.datalen = dataset.shape[0]
        self.index = 0

    def getNextChunk(self, chunksize, **kwargs):
        if chunksize >= self.datalen:
            # chunk covers everything: hand out the whole dataset
            self.index = 0
            whole = np.array(self.dataset)

            return whole if self.labels is None else (whole, np.array(self.labels))

        begin = self.index
        self.index = (begin + chunksize) % self.datalen if begin + chunksize > self.datalen \
            else begin + chunksize

        chunk = _wrapRead(self.dataset, begin, chunksize, self.datalen)
        if self.labels is None:
            return chunk

        return chunk, _wrapRead(self.labels, begin, chunksize, self.datalen)

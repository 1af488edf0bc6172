"""Activation-range calibration for int8 engines (counterpart of
``puzzlelib_tpu/converter/engine/datacalibrator.py``).

``DataCalibrator.calibrate(net, modules)`` runs the calibration batches
through the eager net with a hook around each module's ``updateData``: pass
1 finds each module's |activation| max, pass 2 builds a fixed-range
histogram; then it picks a clipping threshold either by max (``minmax``) or
by minimizing the KL divergence between the clipped f32 distribution and its
128-level quantized projection (``entropy``, the TensorRT algorithm).

The batches go to the configured device (``Config.device``; with none set
and no card, the upload raises).  The max is reduced on the device, which
gives the same value as the reference's reduction on the host, since a max
is exact; only the entropy pass copies the activations to the host, for
numpy's histogram.
"""

import numpy as np

from puzzlelib_tpu_torch.backend import gpuarray


class DataCalibrator:
    def __init__(self, data, batchsize=32, algo="entropy", bins=2048):
        if algo not in ("entropy", "minmax"):
            raise ValueError("Unrecognized calibration algo '%s'" % algo)

        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.batchsize = batchsize

        self.algo = algo
        self.bins = bins

    def _sweep(self, net, modules, onInput):
        """Run all calibration batches with ``onInput(mod, data)`` hooks; the
        modules' own ``updateData`` is restored afterwards."""
        own = {id(mod): mod.__dict__.get("updateData") for mod in modules}

        def makeHook(mod):
            inner = mod.updateData

            def hooked(data):
                onInput(mod, data)
                inner(data)

            return hooked

        for mod in modules:
            mod.updateData = makeHook(mod)

        try:
            for i in range(0, self.data.shape[0], self.batchsize):
                net(gpuarray.to_gpu(self.data[i:i + self.batchsize]))
                net.reset()
        finally:
            for mod in modules:
                if own[id(mod)] is None:
                    del mod.updateData
                else:
                    mod.updateData = own[id(mod)]

    def calibrate(self, net, modules):
        """Return {id(module): activation scale} for every module given."""
        maxes = {id(mod): 0.0 for mod in modules}

        def recordMax(mod, data):
            if data.numel():
                maxes[id(mod)] = max(maxes[id(mod)], data.detach().float().abs().max().item())

        self._sweep(net, modules, recordMax)

        if self.algo == "minmax":
            return {
                key: np.float32(top / 127.0 if top > 0 else 1.0) for key, top in maxes.items()
            }

        hists = {id(mod): np.zeros(self.bins, dtype=np.float64) for mod in modules}

        def recordHist(mod, data):
            top = maxes[id(mod)]
            if top > 0 and data.numel():
                absval = np.abs(gpuarray.get(data).astype(np.float32, copy=False)).ravel()
                hist, _ = np.histogram(absval, bins=self.bins, range=(0.0, top))
                hists[id(mod)] += hist

        self._sweep(net, modules, recordHist)

        scales = {}
        for mod in modules:
            top = maxes[id(mod)]

            if top == 0.0:
                scales[id(mod)] = np.float32(1.0)
            else:
                thr = self._entropyThreshold(hists[id(mod)], top)
                scales[id(mod)] = np.float32(thr / 127.0)

        return scales

    def _entropyThreshold(self, hist, top):
        """TensorRT-style KL sweep: pick the clipping threshold whose clipped
        distribution, projected to 128 quantization levels and expanded back,
        diverges least from the original."""
        nbins = len(hist)
        binWidth = top / nbins

        bestDiv, bestIdx = np.inf, nbins

        # mass floor: a spike at zero dominates the KL and lets the sweep clip
        # real tail mass, so candidate thresholds must retain >= 99.5% of it
        cum = np.cumsum(hist)
        minIdx = int(np.searchsorted(cum, 0.995 * cum[-1])) + 1

        for idx in range(max(128, minIdx), nbins + 1, max(1, nbins // 128)):
            p = hist[:idx].astype(np.float64).copy()
            p[idx - 1] += hist[idx:].sum()                  # clip outliers into the last bin

            total = p.sum()
            if total == 0:
                continue

            # project the first idx bins onto 128 levels, then expand back
            # uniformly over each level's nonzero source bins
            edges = np.linspace(0, idx, 129).round().astype(int)
            q = np.zeros(idx, dtype=np.float64)

            for level in range(128):
                start, stop = edges[level], max(edges[level + 1], edges[level] + 1)
                seg = hist[start:stop].astype(np.float64)
                nonzero = seg > 0

                if nonzero.any():
                    q[start:stop][nonzero] = seg.sum() / nonzero.sum()

            pn, qn = p / total, q / max(q.sum(), 1e-12)
            mask = pn > 0
            div = float(np.sum(pn[mask] * np.log(pn[mask] / np.maximum(qn[mask], 1e-12))))

            if div < bestDiv:
                bestDiv, bestIdx = div, idx

        return bestIdx * binWidth

"""Recurrent layers: relu / tanh / LSTM / GRU, one or two directions, several
levels with dropout between them (counterpart of
``puzzlelib_tpu/backend/rnn.py``).

One flat weight ``W`` carries the named per-gate views of every linear
layer, in the JAX package's layout: interleaved [matrix, bias] per linear
layer (``_LINLAYERS``), pseudo-layer by pseudo-layer (level-major, the
forward direction before the backward one), so ``convertRnnWeights`` and
checkpoints read the same bytes in both packages.

Cell equations (cuDNN's, as in the JAX package):

  relu/tanh: h_t = act(W x + bw + R h + br)
  LSTM: i,f,o = sigma(...), c' = tanh(...); c = f*c + i*c'; h = o*tanh(c)
  GRU:  r,u = sigma(...); h' = tanh(Wh x + bwh + r*(Rh h + brh));
        h = (1-u)*h' + u*h

Everything is computed in f32 whatever the input's type, and the output is
cast back to it.  Each level takes one product of all its input
projections over time (``torch.addmm``, the counterpart of the JAX
package's ``einsum``), then walks the time steps, one (B, H) x (H, G*H)
product and the gate arithmetic a step, the backward direction from the last
step to the first.  The forward runs without autograd; the backward
(``backward``) runs autograd over one recompute of the forward and gives the
input's and the flat weight's gradients in one pass, where the JAX package
takes two VJPs.  Nothing in it reads back to the host, so a fused step
records the whole loop, backward included, in its CUDA graph.

Dropout between levels (below the last only) keeps a cell where its uniform
f32 draw from ``rng`` (``rng.globalRng`` by default) lies below 1 - p and
divides by 1 - p; ``_drawMasks`` is the one place that draws.  The draws are
torch's: a test that holds the two packages to each other injects the JAX
package's masks.
"""

import numpy as np
import torch


_LINLAYERS = {
    "relu": (("wi", ), ("ri", )),
    "tanh": (("wi", ), ("ri", )),
    "lstm": (("wi", "wf", "wc", "wo"), ("ri", "rf", "rc", "ro")),
    "gru": (("wr", "wi", "wh"), ("rr", "ri", "rh")),
}


class RnnDesc:
    def __init__(self, insize, hsize, layers, mode, direction, dropout=0.0, seed=0, batchsize=0):
        from puzzlelib_tpu_torch.rng import globalRng

        self.insize, self.hsize, self.layers = insize, hsize, layers
        self.mode, self.direction = mode, direction
        self.dropout, self.seed = dropout, seed
        self.batchsize = batchsize
        self.rng = globalRng

        self.dirs = 2 if direction == "bi" else 1
        self.pseudoLayers = layers * self.dirs

        self.layout = []  # per pseudo-layer: {name: (offset, shape)}
        self._last = None

        offset = 0
        inW, recW = _LINLAYERS[mode]

        for layer in range(self.pseudoLayers):
            level = layer // self.dirs
            size = insize if level == 0 else hsize * self.dirs

            entry = {}
            for names, width in ((inW, size), (recW, hsize)):
                for name in names:
                    entry[name] = (offset, (hsize, width))
                    offset += hsize * width
                    entry["b" + name] = (offset, (hsize, ))
                    offset += hsize

            self.layout.append(entry)

        self.wsize = offset

    def acquireParams(self, W):
        """The named views of ``W``, one dict per pseudo-layer."""
        return [_carve(W, entry) for entry in self.layout]

    def _drawMasks(self, shape, device):
        """The keep masks of the levels below the last, each of ``shape``."""
        keep = 1.0 - self.dropout
        masks = []

        for _ in range(self.layers - 1):
            rands = torch.empty(shape, dtype=torch.float32, device=device)
            self.rng.fillUniform(rands)
            masks.append(rands < keep)

        return masks

    def forward(self, data, W, test=False):
        """The output (T, B, H * dirs) in data's type; in train mode with
        None for the reserve the reference returns beside it (the backward
        recomputes instead)."""
        dropout = 0.0 if test else self.dropout
        masks = None
        if dropout > 0.0 and self.layers > 1:
            masks = self._drawMasks(tuple(data.shape[:2]) + (self.hsize * self.dirs, ), data.device)

        self._last = (data, W, masks, dropout)

        with torch.no_grad():
            out = _rnnCore(data, W, masks, dropout, self)

        return out if test else (out, None)

    def backward(self, grad, withData=True):
        """(input gradient or None, flat weight gradient) of the last
        forward for the output gradient ``grad``: autograd over one
        recompute of it."""
        data, W, masks, dropout = self._last

        x = data.detach().requires_grad_(withData)
        w = W.detach().requires_grad_(True)

        with torch.enable_grad():
            out = _rnnCore(x, w, masks, dropout, self)
            grads = torch.autograd.grad(out, (x, w) if withData else (w, ), grad_outputs=grad)

        return (grads[0], grads[1]) if withData else (None, grads[0])


def _carve(W, entry):
    return {name: W[offset:offset + int(np.prod(shape))].view(shape) for name, (offset, shape) in entry.items()}


def _cellLoop(mode, xproj, p, reverse):
    """The hidden states (T, B, H) of one direction of one level, from the
    input projections plus their biases ``xproj`` (T, B, G*H).  The steps
    read the rows of one ``unbind`` and write one ``stack``, whose
    backwards are one stack and one unbind, where indexing would give each
    step a zero gradient of the whole (T, B, G*H) to add."""
    T, B = xproj.shape[:2]
    recNames = _LINLAYERS[mode][1]
    H = p[recNames[0]].shape[0]

    RT = torch.cat([p[name] for name in recNames], dim=0).t()           # (H, G*H)
    br = torch.cat([p["b" + name] for name in recNames])

    h = xproj.new_zeros((B, H))
    hs = [None] * T

    if mode in ("relu", "tanh"):
        # relu as max(v, 0), whose gradient at v == 0 is a half, as
        # jnp.maximum's in the JAX package (torch.relu's is 0): a step whose
        # inputs are all zero (dropped out) has a zero pre-activation
        zero = xproj.new_zeros(())
        act = torch.tanh if mode == "tanh" else (lambda v: torch.maximum(v, zero))
        xs = (xproj + br).unbind(0)

        for t in (reversed(range(T)) if reverse else range(T)):
            h = hs[t] = act(torch.addmm(xs[t], h, RT))

    elif mode == "lstm":
        xs = (xproj + br).unbind(0)
        c = xproj.new_zeros((B, H))

        for t in (reversed(range(T)) if reverse else range(T)):
            z = torch.addmm(xs[t], h, RT)
            s = torch.sigmoid(z)
            i, f, o = s[:, :H], s[:, H:2 * H], s[:, 3 * H:]

            c = torch.addcmul(f * c, i, torch.tanh(z[:, 2 * H:3 * H]))
            h = hs[t] = o * torch.tanh(c)

    elif mode == "gru":
        xs = xproj.unbind(0)

        for t in (reversed(range(T)) if reverse else range(T)):
            hr = torch.addmm(br, h, RT)                                 # R h + br, (B, 3H)
            xp = xs[t]

            ru = torch.sigmoid(xp[:, :2 * H] + hr[:, :2 * H])
            r, u = ru[:, :H], ru[:, H:]
            hh = torch.tanh(torch.addcmul(xp[:, 2 * H:], r, hr[:, 2 * H:]))

            h = hs[t] = (1.0 - u) * hh + u * h

    else:
        raise NotImplementedError(mode)

    return torch.stack(hs)


def _rnnCore(x, W, masks, dropout, desc):
    T, B = x.shape[0], x.shape[1]
    inNames = _LINLAYERS[desc.mode][0]

    current = x.float()
    Wf = W.float()

    for level in range(desc.layers):
        outs = []
        for d in range(desc.dirs):
            p = _carve(Wf, desc.layout[level * desc.dirs + d])

            Wx = torch.cat([p[name] for name in inNames], dim=0)             # (G*H, in)
            bw = torch.cat([p["b" + name] for name in inNames])

            xproj = torch.addmm(bw, current.reshape(T * B, -1), Wx.t()).view(T, B, -1)
            outs.append(_cellLoop(desc.mode, xproj, p, reverse=(d == 1)))

        current = outs[0] if desc.dirs == 1 else torch.cat(outs, dim=-1)

        if masks is not None and level < desc.layers - 1:
            current = current * masks[level] / (1.0 - dropout)

    return current.to(x.dtype)


# -- backend Dnn-facing API --------------------------------------------------------------

def createRnn(insize, hsize, layers, mode, direction, dropout=0.0, seed=0, batchsize=None):
    """(desc, the flat f32 weight W of zeros on the configured device, its
    named views)."""
    from puzzlelib_tpu_torch.backend import gpuarray

    mode = getattr(mode, "value", mode)
    direction = getattr(direction, "value", direction)

    desc = RnnDesc(insize, hsize, layers, mode, direction, dropout, seed, 0 if batchsize is None else batchsize)

    W = gpuarray.zeros((desc.wsize, ), np.float32)
    return desc, W, desc.acquireParams(W)


def acquireRnnParams(desc, w):
    return desc.acquireParams(w)

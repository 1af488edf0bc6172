"""The SegNet slice, as ``chip_smoke.py`` and the tests run it.

SegNet (Badrinarayanan, Kendall and Cipolla, TPAMI 2017) at full width,
built here from the port's modules (the zoo has no loader for it): VGG-16's
13 convs as the encoder, each 3x3 with pad 1 and followed by a
``BatchNorm2D`` and a relu, its five stages of 2, 2, 3, 3 and 3 convs of 64,
128, 256, 512 and 512 maps each ending in ``MaxPool2D(2, 2, useMask=True)``;
a decoder that mirrors it, each stage opening with a ``MaxUnpool2D`` of
that stage's pool and the last conv of each stage narrowing to the next
stage's width; and the head ``conv1_1_D``, a 3x3 conv from 64 maps to 12
(CamVid's 11 classes and void).  In bf16 a ``Cast`` to f32 follows it.
A conv followed by a batch norm has no bias, as ResNet's have none: the
batch norm's shift takes its place, and such a bias's gradient is 0 (the
reference's SegNet carries one; its gradient is rounding noise).
29,441,996 parameters (``buildNet().numOfParams()``).

Input: CamVid's 3 x 360 x 480 at batch 4, in bf16 with the batch norms'
scales and biases in f32, as the ResNet-50 slice runs.  The repo holds no
CamVid file: ``data`` seeds block images whose labels are read off them,
each image with the same share of each class, so that the loss can fall
from a batch to the next.  Training: per-pixel ``CrossEntropy`` and
``MomentumSGD(LEARN_RATE, 0.9)`` in global state.  The reference's
cross-entropy gradient is not divided by the pixels of a map, so the rate
is small: at 1e-7 every step's loss fell on both routes (2.83 to 2.35 in
4 steps); at 2e-7 the fourth step's fell by 1.5 % only, and from 5e-7 on
a step's loss rose (``main``, on an H100).  SegNet weighs CamVid's classes by median-frequency balancing
(``classWeights``: void's weight 0); the slice does not, since the
reference's weighted gradient, w[c] * (onehot - softmax), weighs each
class's score by that class's weight and not by the label's, so it is no
gradient of the weighted loss, and under these weights (0.14 to 4.25) the
steps raise that loss at every rate.  ``python3 -m
puzzlelib_tpu_torch.tools.segslice --rates ...`` trains 4 steps at each
rate on the hand and library routes, with the plain and the weighted cost,
and prints the losses.

On the card K2 takes the forward, K2 the bwd-data and K3 the bwd-filter of
the 20 3x3 convs whose channels are multiples of 128
(``winograd.applicable``, counted from the net by
``resnetslice.winogradConvs``): conv2_2 and conv3_1 to conv5_3 of the
encoder, conv5_3_D to conv2_2_D of the decoder.  conv1_1, conv1_2,
conv2_1, conv2_1_D, conv1_2_D and the head go to cuDNN.

Weights come from ``np.random.seed(0)``: He-scaled normals for the convs
and zero biases (``zooslice.heTable``), batch norm scales 1 and biases 0.
A ``resnetslice.Run`` restarts every ``train`` from the same weights,
running stats and zero momentum, on the route that ``algo`` names:
"hopper" (the hand kernels), "torch" (the library) or "fused"
(``FusedTrainer``, ``FusedValidator`` and ``FusedCalculator`` on the hand
kernels).  The device is the caller's ``Config.device``.
"""

import argparse

import numpy as np

from puzzlelib_tpu_torch.tools import resnetslice as Res
from puzzlelib_tpu_torch.tools import zooslice as Zoo


BATCH = 4
STEPS = 4
SHAPE = (3, 360, 480)
CLASSES = 12
VOID = 11
LEARN_RATE, MOM_RATE = 1e-7, 0.9

# VGG-16's encoder: (convs, maps) a stage
ENCODER = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

# the seeded data: labels on blocks of BLOCK x BLOCK pixels, each class
# on its share of an image's blocks (sky, building, pole, road, sidewalk,
# tree, sign, fence, car, pedestrian, bicyclist, void: uneven, as CamVid's
# classes are; not CamVid's own counts)
BLOCK = 20
SHARES = (0.15, 0.22, 0.01, 0.27, 0.06, 0.10, 0.01, 0.02, 0.04, 0.01, 0.01, 0.10)


def _convBlock(net, M, inmaps, outmaps, name, bnrelu=True):
    net.append(M.Conv2D(inmaps, outmaps, 3, pad=1, useBias=not bnrelu, initscheme="none", name=name))
    if bnrelu:
        net.append(M.BatchNorm2D(outmaps, name=name + "_bn"))
        net.append(M.Activation(M.relu, name=name + "_relu"))


def buildNet(encoder=ENCODER, classes=CLASSES, inmaps=3, modules=None, containers=None):
    """SegNet of ``encoder`` ((convs, maps) a stage) to ``classes`` maps from
    ``modules`` and ``containers`` (the port's by default; the tests pass
    the JAX package's), its weights unset ("none")."""
    if modules is None:
        from puzzlelib_tpu_torch import containers, modules

    M = modules
    net = containers.Sequential(name="SegNet")

    pools, width = [], inmaps
    for stage, (convs, maps) in enumerate(encoder, 1):
        for k in range(1, convs + 1):
            _convBlock(net, M, width, maps, "conv%d_%d" % (stage, k))
            width = maps

        pools.append(M.MaxPool2D(2, 2, useMask=True, name="pool%d" % stage))
        net.append(pools[-1])

    for stage in range(len(encoder), 0, -1):
        convs, maps = encoder[stage - 1]
        net.append(M.MaxUnpool2D(pools[stage - 1], name="upsample%d" % stage))

        for k in range(convs, 0, -1):
            head = stage == 1 and k == 1
            outmaps = maps if k > 1 else classes if head else encoder[stage - 2][1]
            _convBlock(net, M, maps, outmaps, "conv%d_%d_D" % (stage, k), bnrelu=not head)

    return net


def weightTable(net):
    """``zooslice.heTable`` of ``net`` from ``np.random.seed(0)``, with every
    batch norm's scale 1 and bias 0."""
    np.random.seed(0)
    table = Zoo.heTable(net)

    for name in table:
        if name.endswith("_bn.scale"):
            table[name] = np.ones_like(table[name])
        elif name.endswith("_bn.bias"):
            table[name] = np.zeros_like(table[name])

    return table


def setType(net, dtype):
    """``net`` (in f32, with no ``Cast`` yet) in ``dtype``, followed in a
    type other than f32 by a ``Cast`` to f32."""
    import torch

    from puzzlelib_tpu_torch.modules import Cast

    net.calcMode(dtype)
    if dtype != torch.float32:
        net.append(Cast(dtype, torch.float32, name="cast"))

    return net


def build(dtype=None, encoder=ENCODER, classes=CLASSES):
    """SegNet with ``weightTable``'s weights, ``setType`` to ``dtype`` (bf16
    by default).  Clears ``Config.globalEvalMode``: training needs gradient
    buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    Config.globalEvalMode = False
    net = buildNet(encoder, classes)
    paramsFromNumpy(net, weightTable(net))
    return setType(net, torch.bfloat16 if dtype is None else dtype)


def data(count, seed=1, shape=SHAPE, classes=CLASSES, block=BLOCK, shares=SHARES):
    """``count`` seeded f32 images of ``shape`` and their int32 label maps
    (count, height, width).  Each image is cut into blocks of ``block`` x
    ``block`` pixels and holds the same number of blocks of each class
    (``shares``, placed by a seeded permutation), so that batches differ
    little and a step's loss tells how far the net has learnt.  A block's
    colour is its class's seeded colour plus a small seeded shift, and its
    label is the class whose colour lies nearest to it, read off the
    image's block colours; the image is twice the block colours plus unit
    noise a pixel."""
    rng = np.random.RandomState(seed)
    channels, height, width = shape
    rows, cols = -(-height // block), -(-width // block)

    counts = np.floor(np.array(shares) / sum(shares) * rows * cols).astype(int)
    counts[np.argmax(counts)] += rows * cols - counts.sum()
    drawn = np.stack([rng.permutation(np.repeat(np.arange(classes), counts)) for _ in range(count)])

    centroids = rng.randn(classes, channels)
    colours = centroids[drawn] + 0.05 * rng.randn(count, rows * cols, channels)
    coarse = np.argmin(((colours[..., None, :] - centroids) ** 2).sum(axis=-1), axis=-1)

    def spread(blocks):
        grid = blocks.reshape((count, rows, cols) + blocks.shape[2:])
        return grid.repeat(block, axis=1).repeat(block, axis=2)[:, :height, :width]

    labels = spread(coarse).astype(np.int32)
    images = (2 * spread(colours).transpose(0, 3, 1, 2) + rng.randn(count, *shape)).astype(np.float32)
    return images, labels


def classWeights(labels, classes=CLASSES, void=VOID):
    """Median-frequency balancing (Eigen and Fergus, as SegNet weights
    CamVid): a class's frequency is its pixels over the pixels of the maps
    it appears in, its weight the median frequency of the classes other
    than void over its own; void's weight is 0, as SegNet ignores it."""
    counts = np.stack([(labels == c).reshape(len(labels), -1).sum(axis=1) for c in range(classes)])
    present = (counts > 0) * labels[0].size

    freq = counts.sum(axis=1) / np.maximum(present.sum(axis=1), 1)
    kept = [c for c in range(classes) if c != void and freq[c] > 0]

    weights = np.zeros(classes, np.float32)
    weights[kept] = np.median(freq[kept]) / freq[kept]
    return weights


def buildRun(net=None, dtype=None, batch=BATCH, weights=None, learnRate=None):
    """A ``resnetslice.Run`` of ``net`` (default ``build(dtype)``; a given
    net is in its type already) with ``MomentumSGD(learnRate, 0.9)``
    (``LEARN_RATE`` by default) in global state and
    ``CrossEntropy(weights=weights)`` (no class weights by default)."""
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    net = build(dtype) if net is None else net
    optimizer = MomentumSGD(LEARN_RATE if learnRate is None else learnRate, momRate=MOM_RATE)
    optimizer.setupOn(net, useGlobalState=True)
    return Res.Run(net, optimizer, CrossEntropy(maxlabels=CLASSES, weights=weights), batch)


class pinnedMasks:
    """Within ``with``, each masked ``MaxPool2D`` of ``net`` named in
    ``masks`` takes its maxima at the cells of its mask there (a gather), so
    that every unpool scatters to the same cells as the run that made the
    masks; None pins nothing.  bf16 rounding flips some argmaxes against
    f32 (or one route's rounding against another's), and the unpools carry
    each flip to other cells, so two runs of SegNet are compared on one
    run's masks."""

    def __init__(self, net, masks):
        self.pools = [(net.getByName(name), mask) for name, mask in (masks or {}).items()]

    def __enter__(self):
        import torch

        for pool, mask in self.pools:
            def update(data, pool=pool, mask=mask):
                pool.data = torch.gather(data.flatten(2), 2, mask.flatten(2)).view(mask.shape)
                pool.mask = mask

            pool.updateData = update
        return self

    def __exit__(self, *exc):
        for pool, _ in self.pools:
            del pool.updateData


def masksOf(net):
    """{name: mask} of ``net``'s masked pools after a forward."""
    from puzzlelib_tpu_torch.modules import MaxPool2D

    return {mod.name: mod.mask for mod in net.graph if isinstance(mod, MaxPool2D) and mod.useMask}


def convInputs(net, inshape):
    """[(conv, input shape)] of every conv of ``net`` for an input of
    ``inshape``: ``resnetslice.convInputs``'s walk, but an unpool answers
    the extent its pool read, as its forward restores it, where its
    ``dataShapeFrom`` answers the reference's (short of it after a floor
    pooling)."""
    from puzzlelib_tpu_torch.modules import ConvND, MaxPool2D, MaxUnpool2D

    found, pooled, shape = [], {}, tuple(inshape)
    for mod in net.graph:
        if isinstance(mod, ConvND):
            found.append((mod, shape))
        elif isinstance(mod, MaxPool2D):
            pooled[id(mod)] = shape

        shape = (shape[:2] + pooled[id(mod.maxpool2d)][2:] if isinstance(mod, MaxUnpool2D)
                 else tuple(mod.dataShapeFrom(shape)))

    return found


def winogradConvs(net, batch=BATCH, shape=SHAPE):
    """The names of the convs that K2 and K3 take at ``batch`` on ``shape``."""
    return Res.winogradConvs(net, (batch, ) + tuple(shape))


def kernelConvs(net, batch=BATCH, shape=SHAPE):
    """K2's convs of ``net`` grouped by shape, for ``chip_smoke._convKernels``:
    [(space-separated names, x shape at batch 1, output maps)], with the
    extents the forward gives them."""
    groups, names = {}, winogradConvs(net, batch, shape)
    for conv, inshape in convInputs(net, (1, ) + tuple(shape)):
        if conv.name in names:
            groups.setdefault((tuple(inshape[1:]), conv.W.shape[0]), []).append(conv.name)

    return [(" ".join(names), inshape, co) for (inshape, co), names in groups.items()]


def main(argv=None):
    """Train ``STEPS`` steps of ``BATCH`` at each rate of ``--rates`` on the
    hand and the library route, from the same start, with the plain and
    the class-weighted ``CrossEntropy`` (``classWeights``), and print each
    run's losses; returns {(cost, rate): {route: losses}}."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.tools.timing import cardName

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--rates", type=float, nargs="+", default=[LEARN_RATE])
    args = parser.parse_args(argv)

    if Config.device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the SegNet slice needs an NVIDIA GPU")
        print(cardName())
        Config.device = "cuda"

    images, labels = data(BATCH * STEPS)
    seen = {}
    for cost, weights in (("plain", None), ("weighted", classWeights(labels))):
        run = buildRun(weights=weights)
        for rate in args.rates:
            run.optimizer.learnRate = rate
            for algo in ("hopper", "torch"):
                losses = seen.setdefault((cost, rate), {}).setdefault(algo, [])
                run.train(algo, images, labels, losses)
                print("%s CrossEntropy, rate %g, %s route: losses %s, falling %s" %
                      (cost, rate, algo, " ".join("%.6f" % loss for loss in losses),
                       all(b < a for a, b in zip(losses, losses[1:]))))

        del run

    return seen


if __name__ == "__main__":
    main()

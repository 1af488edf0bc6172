"""Spatial transformer: the affine grid and bilinear sampling, forward and
backward (counterpart of ``puzzlelib_tpu/ops/spatialtf.py``, cuDNN's
SpatialTf semantics).

theta (N, 2, 3) maps normalized output coordinates (x, y, 1) in [-1, 1] to
normalized input coordinates; sampling is bilinear, zero outside the input,
with the grid's corners on the corner cells' centres (align_corners).

- The base coordinates are ``linspace(-1, 1, n)`` along each side, as the
  reference builds them (``_linspace``): at n = 1 that is -1, where
  ``torch.nn.functional.affine_grid`` puts 0.  So the grid is built here,
  in f32, as three products an output cell.
- Sampling gathers the four corners of each sample, each weighed by its
  bilinear weight and by whether it lies inside the input.
- The data gradient adds each output cell's gradient, times a corner's
  weight, into that corner.  The adds go through one ``index_put_`` with
  ``accumulate``, which on the card sorts the offsets and adds in one order,
  so it gives the same bits at each call; ``grid_sample``'s backward adds
  with atomics.
- The grid gradient is the gradient contracted with the corners'
  differences over the maps; the theta gradient is the grid gradient
  contracted with the base coordinates, as the reference takes it.
"""

import torch


def _linspace(n, device):
    """n points from -1 to 1 in f32 as ``jnp.linspace`` computes them:
    -1 * (1 - s) + 1 * s with s = i / (n - 1), the last point 1; -1 alone
    where n is 1.  The reference's bilinear weights and the theta gradient
    are not smooth where a sample falls on a cell (the identity transform),
    so the points are the reference's to the bit, not ``torch.linspace``'s,
    whose rounding differs.  They are computed on the host: on the card a
    division by a scalar multiplies by its reciprocal, one rounding more, and
    a sample's column, which scales the point by the input's width, moves by
    that much on every device but the CPU."""
    if n == 1:
        points = torch.full((1, ), -1.0)
    else:
        s = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
        points = torch.cat([s - (1 - s), torch.ones(1)])

    return points.to(device)


def baseCoords(h, w, device):
    """(X, Y): the (h, w) grids of the normalized output coordinates."""
    ys, xs = _linspace(h, device), _linspace(w, device)
    return xs.view(1, w).expand(h, w), ys.view(h, 1).expand(h, w)


def affineGrid(theta, h, w):
    """The sampling grid (N, h, w, 2) in f32, (x, y) in the input's
    normalized coordinates."""
    X, Y = baseCoords(h, w, theta.device)
    t = theta.float()[:, :, :, None, None]
    return torch.stack([t[:, i, 0] * X + t[:, i, 1] * Y + t[:, i, 2] for i in range(2)], dim=-1)


def _corners(x, grid):
    """The four corners of each sample: [(flat offset into an input map
    (N, h * w), weight (N, h * w) times inside, inside (N, h * w),
    d weight / d gx, d weight / d gy)], and the scales of d gx / d grid x and
    d gy / d grid y."""
    n, _, hin, win = x.shape
    sx, sy = 0.5 * (win - 1), 0.5 * (hin - 1)

    gx = ((grid[..., 0] + 1.0) * sx).reshape(n, -1)
    gy = ((grid[..., 1] + 1.0) * sy).reshape(n, -1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0

    corners = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = ((yi >= 0) & (yi <= hin - 1) & (xi >= 0) & (xi <= win - 1)).float()
        offset = yi.clamp(0, hin - 1).long() * win + xi.clamp(0, win - 1).long()

        fx, fy = wx if dx else 1 - wx, wy if dy else 1 - wy
        corners.append((offset, fx * fy * inside, inside, (1 if dx else -1) * fy, (1 if dy else -1) * fx))

    return corners, sx, sy


def _gather(xf, offset):
    """xf (N, C, h * w)'s cells at ``offset`` (N, P) -> (N, C, P)."""
    return torch.gather(xf, 2, offset[:, None, :].expand(-1, xf.shape[1], -1))


def bilinearSample(x, grid):
    """x (N, C, hin, win) sampled at ``grid`` (N, h, w, 2) -> (N, C, h, w) in
    x's type."""
    n, c = x.shape[:2]
    h, w = grid.shape[1:3]
    xf = x.float().reshape(n, c, -1)

    out = None
    for offset, weight, _, _, _ in _corners(x, grid)[0]:
        term = _gather(xf, offset) * weight[:, None, :]
        out = term if out is None else out + term

    return out.reshape(n, c, h, w).to(x.dtype)


def spatialTf(x, theta, outshape=None):
    """(output (N, C, h, w), grid): x sampled on theta's grid; (h, w) are
    ``outshape[-2:]``, x's own by default."""
    h, w = tuple(x.shape[2:]) if outshape is None else tuple(outshape[-2:])
    grid = affineGrid(theta, h, w)
    return bilinearSample(x, grid), grid


def spatialTfBackward(grad, x, grid):
    """(dx in x's type, dtheta (N, 2, 3) in x's type)."""
    n, c, hin, win = x.shape
    h, w = grad.shape[2:]
    g = grad.float().reshape(n, c, -1)
    xf = x.float().reshape(n, c, -1)

    corners, sx, sy = _corners(x, grid)
    base = (torch.arange(n, device=x.device) * c)[:, None, None] + torch.arange(c, device=x.device)[None, :, None]

    offsets, values = [], []
    dgx, dgy = 0.0, 0.0
    for offset, weight, inside, dwx, dwy in corners:
        offsets.append((base * (hin * win) + offset[:, None, :]).reshape(-1))
        values.append((g * weight[:, None, :]).reshape(-1))

        dot = (g * _gather(xf, offset)).sum(dim=1) * inside
        dgx = dgx + dot * dwx
        dgy = dgy + dot * dwy

    dx = torch.zeros(n * c * hin * win, dtype=torch.float32, device=x.device)
    dx.index_put_((torch.cat(offsets), ), torch.cat(values), accumulate=True)

    dgx, dgy = (dgx * sx).reshape(n, h, w), (dgy * sy).reshape(n, h, w)
    X, Y = baseCoords(h, w, x.device)
    dtheta = torch.stack([torch.stack([(d * X).sum(dim=(1, 2)), (d * Y).sum(dim=(1, 2)), d.sum(dim=(1, 2))], dim=1)
                          for d in (dgx, dgy)], dim=1)

    return dx.reshape(x.shape).to(x.dtype), dtheta.to(x.dtype)

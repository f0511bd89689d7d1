"""Goodness-of-fit checks for sampler/density agreement (the port's own
copy of ``numpyro_tpu/distributions/gof.py``, after the public ``goftests``
library; Bickel and Breiman 1983 for the multivariate statistic).  The
returned value is a p-value, Uniform(0, 1) when ``sample`` and ``log_prob``
agree: test suites assert ``gof > TEST_FAILURE_RATE``.

Host-side NumPy and scipy on tensors brought to the host (detached, on the
CPU) or on arrays; the chi-squared accumulations are vectorized.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

__all__ = [
    "InvalidTest",
    "auto_goodness_of_fit",
    "density_goodness_of_fit",
    "exp_goodness_of_fit",
    "lumped_goodness_of_fit",
    "multinomial_goodness_of_fit",
    "torus_goodness_of_fit",
    "unif01_goodness_of_fit",
    "vector_density_goodness_of_fit",
]


class InvalidTest(ValueError):
    """The sample size is too small for the statistic to be trustworthy."""


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bar_chart(probs, counts, width=60):
    peak = max(counts.max(), 1)
    lines = ["{: >8} {: >8}".format("Prob", "Count")]
    order = np.argsort(probs)[::-1]
    for p, c in zip(probs[order], counts[order]):
        lines.append(f"{p: >8.3f} {int(c): >8d} " + "-" * int(round(width * c / peak)))
    print("\n".join(lines))


def multinomial_goodness_of_fit(probs, counts, *, total_count=None, plot=False):
    """Pearson chi-squared test of counts against cell probabilities
    (optionally truncated: counts need not exhaust ``total_count``)."""
    probs, counts = _host(probs), np.asarray(counts)
    assert probs.ndim == 1 and probs.shape == counts.shape
    truncated = total_count is not None
    if not truncated:
        total_count = int(counts.sum())
    else:
        assert total_count >= counts.sum()
    if plot:
        _bar_chart(probs, counts)
    if np.any(np.abs(probs - 1) < 1e-8):
        sure_cell = np.abs(probs - 1) < 1e-8
        return 1.0 if counts[sure_cell].sum() == total_count else 0.0
    assert np.all(probs < 1), "bad probability"
    zero_cells = probs <= 0
    if zero_cells.any():
        warnings.warn("Zero probability in goodness-of-fit test", stacklevel=2)
        if counts[zero_cells].sum() > 0:
            return math.inf
    live = ~zero_cells
    mean = total_count * probs[live]
    variance = mean * (1 - probs[live])
    if not np.all(variance > 1):
        raise InvalidTest("Goodness of fit is inaccurate; use more samples")
    chi_squared = float((((counts[live] - mean) ** 2) / variance).sum())
    dof = int(live.sum()) - (0 if truncated else 1)
    from scipy.stats import chi2

    return float(chi2.sf(chi_squared, dof))


def lumped_goodness_of_fit(probs, counts):
    """Pearson's test of ``counts`` against ``probs`` over the same cells
    (a pmf's values and its tail, say), with the cells expected fewer than 5
    times merged into one, and that one into the smallest other cell where it
    is still expected fewer than 5 times."""
    probs, counts = _host(probs).astype(np.float64), np.asarray(counts)
    n = counts.sum()
    small = probs * n < 5
    cell_probs, cells = list(probs[~small]), list(counts[~small])
    lump_p, lump_c = probs[small].sum(), counts[small].sum()
    if lump_p * n >= 5:
        cell_probs.append(lump_p)
        cells.append(lump_c)
    elif small.any():
        i = int(np.argmin(cell_probs))
        cell_probs[i] += lump_p
        cells[i] += lump_c
    cell_probs = np.array(cell_probs)
    return multinomial_goodness_of_fit(cell_probs / cell_probs.sum(), np.array(cells))


def torus_goodness_of_fit(d, samples, *, cells=12, sub=20):
    """Pearson's test of ``samples`` (``(n, 2)`` angles) against ``d``, a
    float64 distribution on the 2-torus on the CPU with a scalar batch:
    ``cells`` x ``cells`` cells of the torus, each cell's mass by the
    midpoint rule on ``sub`` x ``sub`` points, and the cells expected fewer
    than 5 times merged.  The nearest-neighbour test of
    :func:`auto_goodness_of_fit` measures distances in the square, not on
    the torus, and is not calibrated there (``dev/torus_gof.py``)."""
    m = cells * sub
    g = (torch.arange(m, dtype=torch.float64) + 0.5) / m * 2 * math.pi - math.pi
    grid = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
    mass = d.log_prob(grid).exp().reshape(cells, sub, cells, sub).sum((1, 3)).numpy().ravel()
    mass = mass / mass.sum()
    cell = ((_host(samples).astype(np.float64) + math.pi) / (2 * math.pi) * cells).astype(int)
    cell = cell.clip(0, cells - 1)
    counts = np.bincount(cell[:, 0] * cells + cell[:, 1], minlength=cells * cells)
    small = mass * len(cell) < 5
    probs = np.append(mass[~small], mass[small].sum())
    counts = np.append(counts[~small], counts[small].sum())
    return multinomial_goodness_of_fit(probs / probs.sum(), counts)


def unif01_goodness_of_fit(samples, *, plot=False):
    """Histogram Uniform(0,1) samples into ~n^(1/3) cells, then chi^2."""
    samples = _host(samples)
    assert samples.min() >= 0 and samples.max() <= 1
    cells = int(round(len(samples) ** 0.333))
    if cells < 7:
        raise InvalidTest("imprecise test, use more samples")
    binned = np.minimum((samples * cells).astype(int), cells - 1)
    counts = np.bincount(binned, minlength=cells)
    return multinomial_goodness_of_fit(np.full(cells, 1 / cells), counts, plot=plot)


def exp_goodness_of_fit(samples, plot=False):
    """Exponential(1) null -> Uniform(0,1) via the survival transform."""
    return unif01_goodness_of_fit(np.exp(-_host(samples)), plot=plot)


def density_goodness_of_fit(samples, probs, plot=False):
    """1D continuous test: order-statistic gaps scaled by local density are
    Exponential(1) under the null."""
    samples, probs = _host(samples), _host(probs)
    assert samples.shape == probs.shape
    if len(samples) <= 100:
        raise InvalidTest("imprecision; use more samples")
    order = np.argsort(samples, kind="stable")
    xs, ps = samples[order], probs[order]
    gaps = np.diff(xs)
    # trapezoid local density between neighbors
    inv_density = 0.5 * (1 / ps[1:] + 1 / ps[:-1])
    return exp_goodness_of_fit(len(xs) * gaps / inv_density, plot=plot)


def volume_of_sphere(dim, radius):
    return radius**dim * math.pi ** (0.5 * dim) / math.gamma(0.5 * dim + 1)


def get_nearest_neighbor_distances(samples):
    try:
        from scipy.spatial import cKDTree

        return cKDTree(samples).query(samples, k=2)[0][:, 1]
    except ImportError:  # pragma: no cover
        sq = (samples**2).sum(-1)
        pairwise = sq[:, None] + sq[None, :] - 2 * samples @ samples.T
        return np.sqrt(np.clip(np.partition(pairwise, 1)[:, 1], 0, None))


def vector_density_goodness_of_fit(samples, probs, *, dim=None, plot=False):
    """Multivariate test: nearest-neighbor-ball masses are Exponential(1)
    under the null (Bickel & Breiman 1983)."""
    samples, probs = _host(samples), _host(probs)
    assert samples.shape and len(samples)
    assert probs.shape == samples.shape[:1]
    dim = samples.shape[-1] if dim is None else dim
    assert dim
    if len(samples) <= 1000 * dim:
        raise InvalidTest("imprecision; use more samples")
    radii = get_nearest_neighbor_distances(samples)
    ball_mass = len(samples) * probs * volume_of_sphere(dim, radii)
    return exp_goodness_of_fit(ball_mass, plot=plot)


def auto_goodness_of_fit(samples, probs, *, dim=None, plot=False):
    """Dispatch on event dimensionality to the 1D or multivariate test."""
    samples, probs = _host(samples), _host(probs)
    assert samples.shape and samples.shape[0]
    assert probs.shape == samples.shape[:1]
    flat = samples.reshape(samples.shape[0], -1)
    ambient = flat.shape[-1]
    if ambient == 0:
        return 1.0
    if ambient == 1:
        return density_goodness_of_fit(flat.reshape(-1), probs, plot=plot)
    return vector_density_goodness_of_fit(
        flat, probs, dim=dim if dim is not None else ambient, plot=plot
    )

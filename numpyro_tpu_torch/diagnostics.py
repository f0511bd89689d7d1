"""MCMC diagnostics (port of ``autocorrelation``, ``autocovariance``,
``effective_sample_size``, ``gelman_rubin``, ``split_gelman_rubin``,
``hpdi``, ``summary`` and ``print_summary`` from
``numpyro_tpu/diagnostics.py``).  Inputs are tensors (or arrays) with axis
0 = chain and axis 1 = draw; results stay on the input's device, except
``summary``'s, which are numpy arrays as the JAX package's are: it computes
on tensors, and only the finished report crosses to the host."""

from __future__ import annotations

import math
from itertools import product

import torch

from numpyro_tpu_torch.util import tree_leaves

__all__ = [
    "autocorrelation",
    "autocovariance",
    "effective_sample_size",
    "gelman_rubin",
    "hpdi",
    "print_summary",
    "split_gelman_rubin",
    "summary",
]


def _float(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _check(x, chains, draws):
    if x.dim() < 2 or x.shape[0] < chains or x.shape[1] < draws:
        raise ValueError(
            f"expected (chains >= {chains}, draws >= {draws}, ...) samples, "
            f"got shape {tuple(x.shape)}"
        )


def gelman_rubin(x):
    """R-hat over axis 0 = chain, axis 1 = draw."""
    x = _float(x)
    _check(x, 2, 2)
    var_within = x.var(dim=1, correction=1)
    var_estimator = var_within.mean(0)
    var_between = x.shape[1] * x.mean(1).var(dim=0, correction=1)
    var_estimator = ((x.shape[1] - 1) / x.shape[1]) * var_estimator + var_between / x.shape[1]
    return torch.sqrt(var_estimator / var_within.mean(0))


def split_gelman_rubin(x):
    """Split-R-hat: halve each chain, then R-hat over the 2C half-chains."""
    x = _float(x)
    _check(x, 1, 4)
    half = x.shape[1] // 2
    return gelman_rubin(torch.cat([x[:, :half], x[:, -half:]], dim=0))


def _fft_next_fast_len(target):
    # the next composite of 2, 3 and 5
    if target <= 2:
        return target
    while True:
        m = target
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return target
        target += 1


def autocorrelation(x, axis=0, bias=True):
    """Autocorrelation along ``axis`` via FFT."""
    x = _float(x)
    n = x.shape[axis]
    m2 = 2 * _fft_next_fast_len(n)
    x = x.movedim(axis, -1)
    centered = x - x.mean(-1, keepdim=True)
    freq = torch.fft.rfft(centered, n=m2, dim=-1)
    autocorr = torch.fft.irfft((freq * freq.conj()).real, n=m2, dim=-1)[..., :n]
    if not bias:
        autocorr = autocorr / torch.arange(n, 0, -1, dtype=x.dtype, device=x.device)
    autocorr = autocorr / autocorr[..., :1]
    return autocorr.movedim(-1, axis)


def autocovariance(x, axis=0, bias=True):
    x = _float(x)
    var = x.movedim(axis, -1).var(-1, correction=0, keepdim=True)
    autocorr = autocorrelation(x, axis=axis, bias=bias).movedim(axis, -1)
    return (autocorr * var).movedim(-1, axis)


def _var_estimates(x):
    var_within = x.var(dim=1, correction=1).mean(0)
    var_estimator = ((x.shape[1] - 1) / x.shape[1]) * var_within
    if x.shape[0] > 1:
        var_between = x.shape[1] * x.mean(1).var(dim=0, correction=1)
        var_estimator = var_estimator + var_between / x.shape[1]
    return var_within, var_estimator


def effective_sample_size(x, bias=True):
    """ESS over axis 0 = chain, axis 1 = draw, with Geyer's initial
    monotone sequence truncation."""
    x = _float(x)
    _check(x, 1, 2)
    gamma_k_c = autocovariance(x, axis=1, bias=bias)
    var_within, var_estimator = _var_estimates(x)
    rho_k = torch.cat(
        [
            torch.ones_like(var_estimator)[None],
            1.0 - (var_within - gamma_k_c.mean(0)[1:]) / var_estimator,
        ],
        dim=0,
    )
    # Geyer initial positive sequence over (even, odd) pairs
    n_pairs = rho_k.shape[0] // 2
    Rho_k = rho_k[: 2 * n_pairs : 2] + rho_k[1 : 2 * n_pairs : 2]
    # zero everything after the first non-positive pair (a running AND,
    # JAX's associative_scan, is a running min over 0/1 integers)
    all_positive_so_far = torch.cummin((Rho_k > 0).to(torch.int32), dim=0).values.bool()
    Rho_k = torch.where(all_positive_so_far, Rho_k, 0.0)
    # initial monotone (decreasing) sequence
    Rho_k = torch.cummin(Rho_k, dim=0).values.clamp(min=0.0)
    tau = -1.0 + 2.0 * Rho_k.sum(0)
    total = x.shape[0] * x.shape[1]
    tau = torch.clamp(tau, min=1.0 / math.log10(max(total, 10)))
    return total / tau


def hpdi(x, prob=0.90, axis=0):
    """The narrowest interval that holds ``prob`` of the draws along
    ``axis``: its two ends, stacked along ``axis``."""
    x = _float(x).transpose(axis, 0)
    sorted_x = x.sort(0).values
    mass = x.shape[0]
    index_length = int(prob * mass)
    intervals_length = sorted_x[index_length:] - sorted_x[: mass - index_length]
    index_start = intervals_length.argmin(0)[None]
    hpd_left = torch.take_along_dim(sorted_x, index_start, 0).transpose(axis, 0)
    hpd_right = torch.take_along_dim(sorted_x, index_start + index_length, 0).transpose(axis, 0)
    return torch.cat([hpd_left, hpd_right], dim=axis)


def _median(x):
    """``numpy.median`` over axis 0: the mean of the two middle values of an
    even count (``torch.median`` takes the lower one)."""
    s = x.sort(0).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _by_site(samples, group_by_chain):
    if not isinstance(samples, dict):
        samples = {f"Param:{i}": v for i, v in enumerate(tree_leaves(samples))}
    if not group_by_chain:
        samples = {k: v[None, ...] for k, v in samples.items()}
    return samples


def summary(samples, prob=0.90, group_by_chain=True):
    """Per site: mean, std, median, the ends of the ``prob`` HPDI, ESS and
    split R-hat (NaN under 4 draws), as numpy arrays keyed as the JAX
    package keys them."""
    samples = _by_site(samples, group_by_chain)
    summary_dict = {}
    for name, value in samples.items():
        value = _float(value)
        value_flat = value.reshape((-1,) + tuple(value.shape[2:]))
        low, high = hpdi(value_flat, prob=prob).chunk(2, dim=0)
        if value.shape[1] >= 4:
            r_hat = split_gelman_rubin(value)
        else:
            r_hat = torch.full(tuple(value.shape[2:]), math.nan)
        stats = {
            "mean": value_flat.mean(0),
            "std": value_flat.std(0, correction=1),
            "median": _median(value_flat),
            f"{50 - prob * 50:.1f}%": low[0],
            f"{50 + prob * 50:.1f}%": high[0],
            "n_eff": effective_sample_size(value),
            "r_hat": r_hat,
        }
        summary_dict[name] = {k: v.cpu().numpy() for k, v in stats.items()}
    return summary_dict


def print_summary(samples, prob=0.90, group_by_chain=True):
    """Print :func:`summary` as a table, one row per coordinate, in the JAX
    package's format."""
    samples = _by_site(samples, group_by_chain)
    summary_dict = summary(samples, prob, group_by_chain=True)

    row_names = {
        k: k + "[" + ",".join(str(x - 1) for x in v.shape[2:]) + "]"
        for k, v in samples.items()
    }
    max_len = max(max((len(x) for x in row_names.values()), default=0), 10)
    name_format = "{:>" + str(max_len) + "}"
    header_format = name_format + " {:>9}" * 7
    columns = [""] + list(list(summary_dict.values())[0].keys())

    print()
    print(header_format.format(*columns))

    row_format = name_format + " {:>9.2f}" * 7
    for name, stats_dict in summary_dict.items():
        shape = stats_dict["mean"].shape
        if len(shape) == 0:
            print(row_format.format(name, *stats_dict.values()))
        else:
            for idx in product(*map(range, shape)):
                idx_str = "[{}]".format(",".join(map(str, idx)))
                print(row_format.format(name + idx_str, *[v[idx] for v in stats_dict.values()]))
    print()

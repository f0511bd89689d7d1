"""MCMC diagnostics (port of ``autocorrelation``, ``autocovariance``,
``effective_sample_size``, ``gelman_rubin`` and ``split_gelman_rubin`` from
``numpyro_tpu/diagnostics.py``).  Inputs are tensors (or arrays) with axis
0 = chain and axis 1 = draw; results stay on the input's device."""

from __future__ import annotations

import math

import torch

__all__ = [
    "autocorrelation",
    "autocovariance",
    "effective_sample_size",
    "gelman_rubin",
    "split_gelman_rubin",
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

"""Stein kernels for SteinVI, SVGD and ASVGD (port of
``numpyro_tpu/contrib/einstein/stein_kernels.py``).

Each kernel's ``compute(rng_key, particles, particle_info, loss_fn)``
returns ``k(x, y)`` on two flat particles; the engine maps it over both
particle axes at once (``torch.func.vmap``), with its gradient in ``x`` for
the repulsive force.  ``mode`` is the shape of ``k(x, y)``: a scalar
(``norm``), a ``(D,)`` vector (``vector``) or a ``(D, D)`` matrix
(``matrix``).  Everything here is plain PyTorch, as the JAX package
computes it outside Pallas (``jnp``, ``vmap``).
"""

from __future__ import annotations

import math

import torch

from numpyro_tpu_torch.contrib.einstein.stein_util import _generator_of
from numpyro_tpu_torch.distributions.util import standard_draw

__all__ = [
    "GraphicalKernel",
    "IMQKernel",
    "LinearKernel",
    "MixtureKernel",
    "ProbabilityProductKernel",
    "RadialGaussNewtonKernel",
    "RandomFeatureKernel",
    "RBFKernel",
    "SteinKernel",
    "median_bandwidth",
]


def _log_factor(n):
    return 1 / math.log(n)


def median_bandwidth(particles, factor_fn):
    """The median of all ``P**2`` pairwise squared distances (the zero
    diagonal included) times ``factor_fn(P)``, plus 1e-5.  The median of an
    even count is the mean of its two middle values, as ``jnp.median``
    takes it (``torch.median`` returns the lower one)."""
    diffs = particles[:, None, :] - particles[None, :, :]
    sq = (diffs**2).sum(-1).flatten().sort().values
    count = sq.numel()
    med = 0.5 * sq[(count - 1) // 2] + 0.5 * sq[count // 2]
    return med.abs() * factor_fn(particles.shape[0]) + 1e-5


def _check(ok, what):
    """Arguments the JAX package asserts on raise ``ValueError`` here."""
    if not ok:
        raise ValueError(f"invalid {what}")


def _reduce(mode, v):
    return v.sum() if mode == "norm" else v


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


class SteinKernel:
    """Base kernel interface; ``mode`` is ``"norm"``, ``"vector"`` or
    ``"matrix"`` (the shape of ``k(x, y)``)."""

    @property
    def mode(self):
        return self._mode

    def compute(self, rng_key, particles, particle_info, loss_fn):
        raise NotImplementedError

    def init(self, rng_key, particles_shape):
        pass


class RBFKernel(SteinKernel):
    """Gaussian RBF with the median heuristic (Liu & Wang 2016).  In matrix
    mode both ``matrix_mode`` values give ``diag(k)`` of the elementwise
    kernel ``k``: ``norm_diag`` multiplies that vector into an identity, as
    the JAX package does."""

    def __init__(self, mode="norm", matrix_mode="norm_diag", bandwidth_factor=_log_factor):
        _check(mode in ("norm", "vector", "matrix"), f"mode {mode!r}")
        _check(matrix_mode in ("norm_diag", "vector_diag"), f"matrix_mode {matrix_mode!r}")
        self._mode = mode
        self.matrix_mode = matrix_mode
        self.bandwidth_factor = bandwidth_factor

    def compute(self, rng_key, particles, particle_info, loss_fn):
        bandwidth = median_bandwidth(particles, self.bandwidth_factor)

        def kernel(x, y):
            kv = torch.exp(-_reduce(self._mode, (x - y) ** 2) / bandwidth)
            if self._mode == "matrix":
                if self.matrix_mode == "norm_diag":
                    return kv * _eye(x.shape[0], x)
                return torch.diag_embed(kv)
            return kv

        return kernel


class IMQKernel(SteinKernel):
    """Inverse multi-quadratic ``(c**2 + |x - y|**2)**beta`` (Gorham &
    Mackey 2017)."""

    def __init__(self, mode="norm", const=1.0, expon=-0.5):
        _check(mode in ("norm", "vector"), f"mode {mode!r}")
        _check(const > 0.0, f"const {const}")
        _check(-1.0 < expon < 0.0, f"expon {expon}")
        self._mode = mode
        self.const = const
        self.expon = expon

    def compute(self, rng_key, particles, particle_info, loss_fn):
        def kernel(x, y):
            return (self.const**2 + _reduce(self._mode, (x - y) ** 2)) ** self.expon

        return kernel


class LinearKernel(SteinKernel):
    """``x . y + 1`` (Liu & Wang 2018)."""

    def __init__(self, mode="norm"):
        self._mode = "norm"

    def compute(self, rng_key, particles, particle_info, loss_fn):
        def kernel(x, y):
            return x @ y + 1

        return kernel


class RandomFeatureKernel(SteinKernel):
    """Random Fourier features (Liu & Wang 2018).  The weights (standard
    normal) and biases (uniform on ``[0, 2 pi)``), one row per particle,
    are drawn with the first step's random state and kept until the
    particles' shape changes: from the run's generator, or through a draw
    source's ``normals`` and ``uniforms``."""

    def __init__(self, mode="norm", bandwidth_subset=None, bandwidth_factor=_log_factor):
        _check(bandwidth_subset is None or bandwidth_subset > 0,
               f"bandwidth_subset {bandwidth_subset}")
        self._mode = "norm"
        self.bandwidth_subset = bandwidth_subset
        self.bandwidth_factor = bandwidth_factor
        self._random_weights = None
        self._random_biases = None

    def init(self, rng_key, particles_shape):
        like = torch.empty((), device=_generator_of(rng_key).device)
        self._random_weights = standard_draw(rng_key, "normal", particles_shape, like)
        self._random_biases = standard_draw(rng_key, "uniform", particles_shape, like) * (
            2 * math.pi)

    def compute(self, rng_key, particles, particle_info, loss_fn):
        if self._random_weights is None or self._random_weights.shape != particles.shape:
            self.init(rng_key, particles.shape)
        bandwidth = median_bandwidth(particles, self.bandwidth_factor)
        ws, bs = self._random_weights, self._random_biases
        if self.bandwidth_subset is not None:
            ws, bs = ws[: self.bandwidth_subset], bs[: self.bandwidth_subset]

        def features(x):
            # row r: sqrt(2) cos((x . w_r + b_r) / bandwidth), b_r a (D,) row
            return math.sqrt(2) * torch.cos(((ws @ x)[:, None] + bs) / bandwidth)

        def kernel(x, y):
            return (features(x) * features(y)).sum()

        return kernel


class MixtureKernel(SteinKernel):
    """A weighted sum of kernels of one mode (Ai et al. 2018)."""

    def __init__(self, ws, kernel_fns, mode="norm"):
        _check(len(ws) == len(kernel_fns) > 0, "weights and kernels")
        self.ws = ws
        self.kernel_fns = kernel_fns
        self._mode = kernel_fns[0].mode

    def compute(self, rng_key, particles, particle_info, loss_fn):
        kernels = [kf.compute(rng_key, particles, particle_info, loss_fn)
                   for kf in self.kernel_fns]

        def kernel(x, y):
            res = self.ws[0] * kernels[0](x, y)
            for w, k in zip(self.ws[1:], kernels[1:]):
                res = res + w * k(x, y)
            return res

        return kernel


class GraphicalKernel(SteinKernel):
    """One kernel per site (``local_kernel_fns`` by name, else
    ``default_kernel_fn``) on its slice of the particle, put together as a
    block-diagonal matrix kernel (Wang, Zeng & Liu 2018)."""

    def __init__(self, mode="matrix", local_kernel_fns=None, default_kernel_fn=None):
        self._mode = "matrix"
        self.local_kernel_fns = local_kernel_fns or {}
        self.default_kernel_fn = default_kernel_fn or RBFKernel()

    def compute(self, rng_key, particles, particle_info, loss_fn):
        local_kernels = []
        for pk, (start, end) in particle_info.items():
            kf = self.local_kernel_fns.get(pk, self.default_kernel_fn)
            fn = kf.compute(rng_key, particles[:, start:end], {pk: (0, end - start)}, loss_fn)
            local_kernels.append((fn, kf.mode, start, end))

        def kernel(x, y):
            blocks = []
            for fn, mode, start, end in local_kernels:
                v = fn(x[start:end], y[start:end])
                if mode == "norm":
                    v = v * _eye(end - start, x)
                elif mode == "vector":
                    v = torch.diag_embed(v)
                blocks.append(v)
            return torch.block_diag(*blocks)

        return kernel


class ProbabilityProductKernel(SteinKernel):
    """The Gaussian probability-product kernel over the ``*_loc`` and
    ``*_scale`` entries of the particles of a mean-field guide (Jebara et al.
    2004).  It reads a scale as ``exp`` of its unconstrained value, although
    ``AutoNormal``'s scale is ``softplus_positive``: the JAX package and
    upstream NumPyro read it so, and the port keeps their kernel."""

    def __init__(self, guide, scale=1.0, mode="norm"):
        self._mode = "norm"
        self.guide = guide
        self.scale = scale

    def compute(self, rng_key, particles, particle_info, loss_fn):
        def index(suffix):
            return torch.cat([
                torch.arange(start, end, device=particles.device)
                for name, (start, end) in particle_info.items() if name.endswith(suffix)
            ])

        loc_idx, scale_idx = index("_loc"), index("_scale")

        def kernel(x, y):
            loc_x, scale_x = x[loc_idx], torch.exp(x[scale_idx])
            loc_y, scale_y = y[loc_idx], torch.exp(y[scale_idx])
            quad = (
                (loc_x / scale_x**2 + loc_y / scale_y**2) ** 2
                / (1 / scale_x**2 + 1 / scale_y**2)
                - (loc_x / scale_x) ** 2
                - (loc_y / scale_y) ** 2
            )
            return torch.exp(0.5 * quad.sum())

        return kernel


class RadialGaussNewtonKernel(SteinKernel):
    """A radial kernel under the Gauss-Newton metric ``M``, the mean over
    particles of the outer product of the loss's gradient, plus ``1e-5 I``
    (Maken et al. 2022; Detommaso et al. 2018).  The gradient is taken in
    forward mode (``jacfwd``), every particle and every tangent on the same
    draws (``randomness="same"``), as the JAX package gives ``loss_fn`` one
    key for all of them."""

    def __init__(self):
        self._mode = "norm"

    def compute(self, rng_key, particles, particle_info, loss_fn):
        jac = torch.func.jacfwd(loss_fn, randomness="same")
        # a 0-dim tangent meeting a Python number comes out in float64
        Js = torch.func.vmap(jac, randomness="same")(particles).to(particles.dtype)
        M = (Js[:, :, None] * Js[:, None, :]).mean(0)
        M = M + 1e-5 * _eye(M.shape[-1], M)
        d = particles.shape[-1]

        def kernel(x, y):
            diff = x - y
            quad = diff @ M @ diff
            return torch.exp(-quad / (2.0 * d))

        return kernel

"""Directional distributions (port of ``numpyro_tpu/distributions/directional.py``:
``VonMises``, ``ProjectedNormal``, ``SineSkewed`` and
``SineBivariateVonMises``, with ``log_bessel_i_orders``).

The numerics are the JAX package's: the von Mises normaliser through
``i0e``, the Bessel values of every order at once by one trapezoid
quadrature product (``(..., 2048) @ (2048, orders)``, a ``torch.matmul``
that runs in full float32 where the caller keeps TF32 off), the
projected-normal density by a radial-moment recurrence valid in any
dimension.  The two rejection samplers (``util.von_mises_centered`` and the
``phi`` marginal of ``SineBivariateVonMises``) draw a fixed count of
proposal rounds at once and take the first accepted one per lane, where the
JAX package loops until every lane accepts: no data-dependent loop, so they
run under ``torch.func.vmap`` and make no host sync on the card."""

from __future__ import annotations

import math

import torch

from . import constraints
from .continuous import _ndtr
from .distribution import Distribution, _as_tensors
from .util import (
    _first_accepted,
    broadcast_shape,
    safe_normalize,
    standard_draw,
    validate_sample,
    von_mises_centered,
)

__all__ = [
    "ProjectedNormal", "SineBivariateVonMises", "SineSkewed", "VonMises", "log_bessel_i_orders",
]

_TWO_PI = 2.0 * math.pi


def _wrap_angle(theta):
    """An angle on the principal branch ``[-pi, pi)``."""
    return torch.remainder(theta + math.pi, _TWO_PI) - math.pi


class VonMises(Distribution):
    arg_constraints = {"loc": constraints.real, "concentration": constraints.positive}
    reparametrized_params = ["loc"]
    support = constraints.circular

    def __init__(self, loc, concentration, *, validate_args=None):
        self._init_broadcast(validate_args, loc=loc, concentration=concentration)

    def sample(self, key, sample_shape=()):
        """Best and Fisher's rejection sampler over fixed rounds
        (``util.von_mises_centered``), shifted to ``loc``."""
        draws = von_mises_centered(key, self.concentration, self.shape(sample_shape))
        return _wrap_angle(draws + self.loc)

    @validate_sample
    def log_prob(self, value):
        # log C = -log(2 pi I0(k)), through the scaled i0e so that a large
        # concentration stays finite
        kappa = self.concentration
        return kappa * (torch.cos(_wrap_angle(value - self.loc)) - 1.0) - (
            math.log(_TWO_PI) + torch.log(torch.special.i0e(kappa)))

    @property
    def mean(self):
        """The circular mean."""
        return torch.broadcast_to(self.loc, self.batch_shape)

    @property
    def variance(self):
        """The circular variance."""
        kappa = self.concentration
        return torch.broadcast_to(1.0 - torch.special.i1e(kappa) / torch.special.i0e(kappa),
                                  self.batch_shape)


_QUAD_POINTS = 2048


def log_bessel_i_orders(max_order, value, num_points=_QUAD_POINTS):
    r"""``log I_m(value)`` for every order ``m = 0 .. max_order`` at once,
    of shape ``value.shape + (max_order + 1,)``, from the integral

    .. math:: I_m(\kappa) e^{-\kappa}
        = \tfrac{1}{\pi}\int_0^\pi e^{\kappa(\cos\theta - 1)} \cos(m\theta)\, d\theta

    by the trapezoid rule on a uniform grid (spectrally accurate: the even
    periodic extension of the integrand is smooth); every order is one
    ``(..., n) @ (n, orders)`` product."""
    kappa = value.unsqueeze(-1)
    dtype = torch.promote_types(torch.float32, kappa.dtype)
    theta = torch.linspace(0.0, math.pi, num_points, dtype=dtype, device=kappa.device)
    # the exponentially scaled envelope peaks at 1 at theta = 0: no overflow
    envelope = torch.exp(kappa * (torch.cos(theta) - 1.0))
    orders = torch.arange(max_order + 1, dtype=dtype, device=kappa.device)
    cos_m_theta = torch.cos(theta.unsqueeze(-1) * orders)
    w = torch.full((num_points,), math.pi / (num_points - 1), dtype=dtype, device=kappa.device)
    w[0] *= 0.5
    w[-1] *= 0.5
    scaled = torch.matmul(envelope * w, cos_m_theta) / math.pi
    return kappa + torch.log(scaled.clamp(min=torch.finfo(dtype).tiny))


def _radial_moment(t, order):
    """``M_k(t) = int_0^inf x^k N(x | t, 1) dx`` by the upward recurrence
    ``M_k = t M_{k-1} + (k - 1) M_{k-2}``."""
    std_cdf = _ndtr(t)
    std_pdf = torch.exp(-0.5 * t * t) / math.sqrt(_TWO_PI)
    m_prev, m_curr = std_cdf, std_pdf + t * std_cdf  # M_0, M_1
    if order == 0:
        return m_prev
    for k in range(2, order + 1):
        m_prev, m_curr = m_curr, t * m_curr + (k - 1) * m_prev
    return m_curr


class ProjectedNormal(Distribution):
    """An isotropic normal projected radially onto the sphere S^{d-1}, in
    any dimension (the density through the radial moments of a unit normal
    shifted along the ray of the value)."""

    arg_constraints = {"concentration": constraints.real_vector}
    reparametrized_params = ["concentration"]
    has_rsample = True
    support = constraints.sphere

    def __init__(self, concentration, *, validate_args=None):
        assert concentration.dim() >= 1
        self.concentration = concentration
        super().__init__(tuple(concentration.shape[:-1]), tuple(concentration.shape[-1:]),
                         validate_args=validate_args)

    @property
    def mean(self):
        """The mean in the sense of a decision point (not the barycenter)."""
        return safe_normalize(self.concentration)

    @property
    def mode(self):
        return safe_normalize(self.concentration)

    def sample(self, key, sample_shape=()):
        eps = standard_draw(key, "normal", self.shape(sample_shape), self.concentration)
        return safe_normalize(self.concentration + eps)

    @validate_sample
    def log_prob(self, value):
        if self._validate_args and tuple(value.shape[-1:]) != self.event_shape:
            raise ValueError(f"Expected event shape {self.event_shape}")
        dim = int(self.concentration.shape[-1])
        conc = self.concentration
        # the concentration's part along the ray through the value, and the
        # rest
        along = (conc * value).sum(-1)
        ortho_sq = (conc * conc).sum(-1) - along.square()
        return (torch.log(_radial_moment(along, dim - 1)) - 0.5 * ortho_sq
                - 0.5 * (dim - 1) * math.log(_TWO_PI))


class SineSkewed(Distribution):
    """The sine-skewing of a symmetric distribution on the torus
    (Ameijeiras-Alonso and Ley, 2019); ``skewness`` lies in the L1 ball."""

    arg_constraints = {"skewness": constraints.l1_ball}
    support = constraints.independent(constraints.circular, 1)

    def __init__(self, base_dist, skewness, *, validate_args=None):
        assert base_dist.event_shape == tuple(skewness.shape[-1:]), (
            "SineSkewed requires one skewness weight per event dim of base_dist.")
        batch_shape = broadcast_shape(base_dist.batch_shape, tuple(skewness.shape[:-1]))
        event_shape = tuple(skewness.shape[-1:])
        self.skewness = torch.broadcast_to(skewness, batch_shape + event_shape)
        self.base_dist = base_dist.expand(batch_shape)
        super().__init__(batch_shape, event_shape, validate_args=validate_args)

    def sample(self, key, sample_shape=()):
        bd = self.base_dist
        ys = bd.sample(key, sample_shape)
        u = standard_draw(key, "uniform", tuple(sample_shape) + self.batch_shape, ys)
        # accept, or reflect about the mean
        keep = u <= 0.5 + 0.5 * (self.skewness * torch.sin(
            torch.remainder(ys - bd.mean, _TWO_PI))).sum(-1)
        return _wrap_angle(torch.where(keep.unsqueeze(-1), ys, -ys + 2 * bd.mean))

    def log_prob(self, value):
        if self._validate_args:
            self._validate_sample(value)
        skew = torch.log1p((self.skewness * torch.sin(
            torch.remainder(value - self.base_dist.mean, _TWO_PI))).sum(-1))
        return self.base_dist.log_prob(value) + skew

    @property
    def mean(self):
        return self.base_dist.mean


# the rounds of SineBivariateVonMises's phi rejection.  The angular central
# Gaussian envelope (_acg_bandwidth) accepts a proposal with probability 0.45
# at the parameters of the JAX package's own cases, and falls towards 0 only
# as the weighted correlation nears +-1 (the marginal turns bimodal): at
# |weighted correlation| <= 0.95 its worst over concentrations from 1e-3 to
# 1e4 is 0.098 (at 1e4 and 0.01; tests/test_torch_directional.py holds that
# corner above 0.095).  Every lane draws SBVM_ROUNDS[0] proposals at once;
# the lanes left unsettled (a share below 0.905^64 = 1.7e-3 at an acceptance
# of 0.095) are gathered into 2 n 1.7e-3 + 64 slots of n lanes, which draw
# SBVM_ROUNDS[1] more.  A lane is left unsettled when more lanes than slots
# are (a binomial tail below 1e-40 at any count of lanes) or when its slot's
# 420 rounds all reject (below 0.905^420 = 6.4e-19 a slot): for any of 1e8
# draws below 1e-12.  This costs 65 rounds a lane where one stage would
# cost 484
SBVM_ROUNDS = (64, 420)
_SBVM_STAGE_ONE_MISS = 0.905 ** SBVM_ROUNDS[0]


class SineBivariateVonMises(Distribution):
    """Two dependent angles on the 2-torus (Singh, Hnizdo and Demchuck,
    2002); a draw takes ``phi`` from its marginal by rejection under an
    angular central Gaussian envelope (Kent, Ganeiber and Mardia, 2018),
    then ``psi`` from its von Mises conditional."""

    arg_constraints = {
        "phi_loc": constraints.circular,
        "psi_loc": constraints.circular,
        "phi_concentration": constraints.positive,
        "psi_concentration": constraints.positive,
        "correlation": constraints.real,
    }
    support = constraints.independent(constraints.circular, 1)
    # the normaliser's series is cut at this order: its terms decay like
    # (rho^2 / 4 k1 k2)^m binom(2m, m)
    _SERIES_ORDERS = 50

    def __init__(self, phi_loc, psi_loc, phi_concentration, psi_concentration,
                 correlation=None, weighted_correlation=None, validate_args=None):
        if (correlation is None) == (weighted_correlation is None):
            given = [k for k, v in (("correlation", correlation),
                                    ("weighted_correlation", weighted_correlation))
                     if v is not None]
            raise ValueError("Exactly one of ['correlation', 'weighted_correlation'] must be "
                             f"specified; got {given}")
        params = _as_tensors({"phi_loc": phi_loc, "psi_loc": psi_loc,
                              "phi_concentration": phi_concentration,
                              "psi_concentration": psi_concentration,
                              "correlation": correlation if correlation is not None
                              else weighted_correlation})
        if weighted_correlation is not None:
            params["correlation"] = params["correlation"] * torch.sqrt(
                params["phi_concentration"] * params["psi_concentration"])
        batch_shape = broadcast_shape(*(tuple(v.shape) for v in params.values()))
        for name, v in params.items():
            setattr(self, name, torch.broadcast_to(v, batch_shape))
        super().__init__(batch_shape, (2,), validate_args=validate_args)

    @property
    def norm_const(self):
        """The log normaliser ``log (2 pi)^2 sum_m binom(2m, m) (rho^2 /
        (4 k_phi k_psi))^m I_m(k_phi) I_m(k_psi)``, with the Bessel values of
        :func:`log_bessel_i_orders`."""
        n_orders = self._SERIES_ORDERS
        dtype = self.correlation.dtype
        m = torch.arange(n_orders, dtype=dtype, device=self.correlation.device)
        log_binom = torch.lgamma(2 * m + 1.0) - 2.0 * torch.lgamma(m + 1.0)
        log_rho_sq = torch.log(self.correlation.square().clamp(min=torch.finfo(dtype).tiny))
        log_ratio = log_rho_sq - torch.log(4.0 * self.phi_concentration * self.psi_concentration)
        log_bessel_sum = (log_bessel_i_orders(n_orders - 1, self.phi_concentration)
                          + log_bessel_i_orders(n_orders - 1, self.psi_concentration))
        series = torch.logsumexp(log_binom + m * log_ratio.unsqueeze(-1) + log_bessel_sum, -1)
        return 2.0 * math.log(_TWO_PI) + series

    @validate_sample
    def log_prob(self, value):
        dphi = value[..., 0] - self.phi_loc
        dpsi = value[..., 1] - self.psi_loc
        energy = (self.phi_concentration * torch.cos(dphi)
                  + self.psi_concentration * torch.cos(dpsi)
                  + self.correlation * torch.sin(dphi) * torch.sin(dpsi))
        return energy - self.norm_const

    def sample(self, key, sample_shape=()):
        n_draws = math.prod(sample_shape)
        n_batch = math.prod(self.batch_shape)
        kappa_phi = self.phi_concentration.reshape(n_batch)
        kappa_psi = self.psi_concentration.reshape(n_batch)
        rho = self.correlation.reshape(n_batch)
        phi = self._sample_phi_marginal(key, (n_draws, n_batch), kappa_phi, kappa_psi, rho)
        # psi | phi is von Mises, its location and concentration set by phi
        sin_phi = torch.sin(phi)
        kappa_cond = torch.sqrt(kappa_psi.square() + (rho * sin_phi).square())
        loc_cond = torch.arctan(rho * sin_phi / kappa_psi)
        psi = VonMises(loc_cond, kappa_cond).sample(key)
        out = torch.stack((_wrap_angle(phi + self.phi_loc.reshape(-1)),
                           _wrap_angle(psi + self.psi_loc.reshape(-1))), -1)
        return out.reshape(tuple(sample_shape) + self.batch_shape + (2,))

    def _sample_phi_marginal(self, key, shape, kappa_phi, kappa_psi, rho):
        """The ``phi`` marginal by rejection under the angular central
        Gaussian envelope in two stages of fixed size (``SBVM_ROUNDS``): a
        lane with no accepted proposal (probability below 1e-20 inside the
        domain of ``SBVM_ROUNDS``) gives NaN."""
        lanes = math.prod(shape)
        params = [p.expand(shape).reshape(lanes) for p in (kappa_phi, kappa_psi, rho)]
        phi = self._rejection_stage(key, SBVM_ROUNDS[0], *params)
        slots = min(lanes, math.ceil(2 * lanes * _SBVM_STAGE_ONE_MISS) + 64)
        # the unsettled lanes first (a stable sort of the settled flags), then
        # their second stage, written back over the first
        pick = torch.argsort(~torch.isnan(phi), stable=True)[:slots]
        again = self._rejection_stage(key, SBVM_ROUNDS[1],
                                      *(torch.gather(p, 0, pick) for p in params))
        first = torch.gather(phi, 0, pick)
        phi = phi.scatter(0, pick, torch.where(torch.isnan(first), again, first))
        return phi.reshape(shape)

    @classmethod
    def _rejection_stage(cls, key, rounds, kappa_phi, kappa_psi, rho):
        """``rounds`` proposals for each lane of the flat parameters at once,
        and the first accepted one (NaN where none is)."""
        gauss = standard_draw(key, "normal", (rounds, 2) + tuple(kappa_phi.shape), kappa_phi)
        u = standard_draw(key, "uniform", (rounds,) + tuple(kappa_phi.shape), kappa_phi)
        phi, log_ratio = cls._phi_proposals(gauss, kappa_phi, kappa_psi, rho)
        return _first_accepted(u < torch.exp(log_ratio), phi)

    @classmethod
    def _phi_proposals(cls, gauss, kappa_phi, kappa_psi, rho):
        """The envelope's proposals made from standard normal pairs
        ``gauss`` (of shape ``(..., 2) + lanes``, the parameters of shape
        ``lanes``), and the log of each one's acceptance probability (above 0
        where it is accepted for sure)."""
        # the Bingham-like exponent of the marginal, shifted so that its
        # smaller eigenvalue is 0, and the envelope's bandwidth
        lam = 0.5 * (kappa_phi - rho.square() / kappa_psi)
        lam_shift = lam.clamp(max=0.0)
        lam_pos = torch.stack((-lam_shift, lam - lam_shift))  # (2,) + lanes
        bandwidth = cls._acg_bandwidth(lam_pos)
        axis = -1 - kappa_phi.dim()
        log_i0_psi = torch.log(torch.special.i0e(kappa_psi)) + kappa_psi
        # an ACG draw: a scaled normal on the circle, as an angle
        vec = gauss * torch.rsqrt(1.0 + 2.0 * lam_pos / bandwidth)
        inv_norm = torch.rsqrt(vec.square().sum(axis))
        cos_w, sin_w = vec.select(axis, 0) * inv_norm, vec.select(axis, 1) * inv_norm
        # log target - log envelope, both unnormalised, with the envelope's
        # bound folded in
        kappa_eff = torch.sqrt(kappa_psi.square() + (rho * sin_w).square())
        log_f = (kappa_phi * (cos_w - 1.0) + lam_shift + torch.log(torch.special.i0e(kappa_eff))
                 + kappa_eff - log_i0_psi)
        quad = bandwidth / 2 + lam_pos[0] * cos_w.square() + lam_pos[1] * sin_w.square()
        log_ratio = log_f + (1.0 - bandwidth / 2) + torch.log(quad)
        return torch.atan2(sin_w, cos_w), log_ratio

    @staticmethod
    def _acg_bandwidth(lam_pos):
        """One Newton step for the envelope's bandwidth ``b`` solving
        ``sum_i 1 / (b + 2 lam_i) = 1`` (Kent, Ganeiber and Mardia), from
        ``b = dim / 2``."""
        b = torch.ones_like(lam_pos[0])
        denom = b + 2.0 * lam_pos
        grad = denom.pow(-2).sum(0)
        curv = -2.0 * denom.pow(-3).sum(0)
        degenerate = torch.linalg.vector_norm(lam_pos, dim=0) == 0
        return torch.where(degenerate, b, b - grad / curv)

    @property
    def mean(self):
        locs = torch.stack((self.phi_loc, self.psi_loc), -1)
        return torch.broadcast_to(_wrap_angle(locs), self.batch_shape + (2,))

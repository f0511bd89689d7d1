"""Shape, log-space and special-function helpers for the distributions layer
(port of the parts of ``numpyro_tpu/distributions/util.py`` that the ported
slices need).

The special functions PyTorch lacks are written here in plain PyTorch, each
with a fixed count of steps, so that none has a data-dependent loop or a host
sync on the card: ``betainc`` (a continued fraction of fixed depth, in
float64 inside), ``betaincinv`` and ``gammaincinv`` (60 and 120 bisection
steps, as in the JAX package), and ``gammainc`` (``torch.special.gammainc``
with its derivative in the shape, which PyTorch lacks).  Their derivatives
are those the JAX package gives; one the port does not give raises, it is
never a silent zero.

Draws: a sampler takes a ``torch.Generator`` or a draw source, an object
with a method per kind of standard variate (``normals(shape, like)``,
``uniforms``, ``exponentials``, ``gumbels``, ``laplaces``, ``logistics``,
``cauchys``; ``gammas(alpha)``; and whole draws of the samplers below,
``binomials(n, p)``, ``poissons(rate)`` and ``von_mises(concentration)``),
through which tests hand the port the JAX package's draws.  The samplers
``binomial``, ``poisson``, ``multinomial`` and ``von_mises_centered`` make a
fixed amount of work from a generator: PyTorch's own binomial and Poisson
samplers (one launch each), and a von Mises rejection over a fixed count of
rounds drawn at once, so none has a data-dependent loop or a host sync, and
each draws a value per element under ``torch.func.vmap(randomness=
"different")``.  The gamma draw's reparameterised derivative is within
about 1e-9 relative of a float64 reference at every shape, in reverse and
forward mode (``_gamma_draw_derivative``); it has no derivative itself.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "betainc", "betaincinv", "betaln", "binomial", "broadcast_shape", "categorical",
    "cholesky", "cholesky_update", "clamp_probs", "gammainc", "gammaincinv", "in_transform",
    "inv", "is_batched", "lazy_property", "logmatmulexp", "multinomial", "poisson",
    "promote_shapes", "safe_normalize", "scale_and_mask", "standard_draw", "standard_gamma",
    "sum_rightmost", "validate_sample", "von_mises_centered",
]


def broadcast_shape(*shapes):
    """The broadcast of shapes given as tuples, as ``torch.broadcast_shapes``
    gives it (a ``RuntimeError`` where they do not broadcast), in plain
    Python: the torch function runs a Python reference implementation of ~70
    us a call, and a potential evaluation calls this for every site."""
    rank = max((len(s) for s in shapes), default=0)
    out = [1] * rank
    for shape in shapes:
        for i, n in enumerate(shape, rank - len(shape)):
            if n != 1:
                if out[i] != 1 and out[i] != n:
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return tuple(out)


def promote_shapes(*args, shape=()):
    """Left-pad arg shapes so they broadcast against each other and ``shape``."""
    if shape == () and len(args) < 2:
        return args
    arg_shapes = [tuple(a.shape) for a in args]
    rank = len(broadcast_shape(shape, *arg_shapes))
    return [
        a if rank == len(s) else a.reshape((1,) * (rank - len(s)) + s)
        for a, s in zip(args, arg_shapes)
    ]


def sum_rightmost(x, dim):
    """Sum out the ``dim`` rightmost dimensions of ``x``."""
    return x.sum(tuple(range(-dim, 0))) if dim else x


def scale_and_mask(x, scale=None, mask=None):
    """Scale a log-prob tensor, with 0 where ``mask`` is False."""
    scaled = x if scale is None else x * scale
    return scaled if mask is None else torch.where(mask, scaled, torch.zeros_like(scaled))


def cholesky_update(L, x, coef=1):
    """Cholesky factor of ``L @ L.T + coef * outer(x, x)``, batched, by the
    rank-one LDL update of Gill, Golub, Murray and Saunders (parity:
    ``cholesky_update`` of ``numpyro_tpu/distributions/util.py``): a Python
    loop over the ``n`` columns, each step on the whole batch."""
    batch_shape = broadcast_shape(tuple(L.shape[:-2]), tuple(x.shape[:-1]))
    n = x.shape[-1]
    L = L.expand(batch_shape + (n, n))
    w = x.expand(batch_shape + (n,))
    diag = L.diagonal(dim1=-2, dim2=-1)
    Lu = L / diag[..., None, :]  # unit-diagonal lower triangular
    D = diag.square()
    rows = torch.arange(n, device=L.device)
    a = torch.full(batch_shape, float(coef), dtype=x.dtype, device=x.device)
    d_new, cols = [], []
    for j in range(n):
        d_j, col = D[..., j], Lu[..., :, j]
        p = w[..., j]
        gamma = d_j + a * p.square()
        beta = p * a / gamma
        a = a * d_j / gamma
        w = w - p[..., None] * col
        cols.append(col + beta[..., None] * w * (rows > j))
        d_new.append(gamma)
    return torch.stack(cols, -1) * torch.stack(d_new, -1).sqrt()[..., None, :]


def logmatmulexp(x, y):
    """``log(exp(x) @ exp(y))`` without overflow: each row of ``x`` and column
    of ``y`` is shifted by its max, held out of the gradient.  The product is
    ``torch.matmul``, so it runs in full f32 where the caller keeps TF32 off
    (``infer.util.pin_full_f32_matmul``)."""
    row_max = x.amax(-1, keepdim=True).detach()
    col_max = y.amax(-2, keepdim=True).detach()
    centered = torch.matmul(torch.exp(x - row_max), torch.exp(y - col_max))
    return torch.log(centered) + row_max + col_max


def is_batched(x):
    """Whether ``x`` carries a ``vmap`` batch at any of its functorch levels
    (its value then cannot be read on the host)."""
    functorch = torch._C._functorch
    while isinstance(x, torch.Tensor) and functorch.is_functorch_wrapped_tensor(x):
        if functorch.is_batchedtensor(x):
            return True
        x = functorch.get_unwrapped(x)
    return False


def in_transform():
    """Whether the code runs inside a ``torch.func`` transform (``vmap``,
    ``grad``, ``jvp``): the port's counterpart of tracing under ``jax.jit``,
    which stages every operation, so that nothing computed there is read on
    the host.  The port's potentials and predictive draws run there."""
    return torch._C._functorch.maybe_current_level() is not None


def _number_as_tensor(dist, value):
    """A Python number given as a value (an ``obs`` or a ``condition``, as
    the JAX package takes them) as a 0-dim tensor, filled on the device of
    the distribution's first tensor attribute: a fill, not a copy from the
    host.  Anything else passes as it is."""
    if isinstance(value, torch.Tensor) or not isinstance(value, (int, float)):
        return value
    like = next((v for v in vars(dist).values() if isinstance(v, torch.Tensor)), None)
    dtype = torch.int64 if isinstance(value, int) else torch.get_default_dtype()
    return torch.full((), value, dtype=dtype, device=None if like is None else like.device)


def validate_sample(log_prob_fn):
    """Decorate a ``log_prob``: a Python number is taken as a 0-dim tensor
    (:func:`_number_as_tensor`), and with validation on, a value outside the
    support gets ``-inf``, selected by ``torch.where`` (no host read)."""

    @functools.wraps(log_prob_fn)
    def wrapper(self, *args, **kwargs):
        if args:
            args = (_number_as_tensor(self, args[0]),) + args[1:]
        elif "value" in kwargs:
            kwargs["value"] = _number_as_tensor(self, kwargs["value"])
        out = log_prob_fn(self, *args, **kwargs)
        if self._validate_args:
            value = kwargs.get("value", args[0] if args else None)
            out = torch.where(self._validate_sample(value), out, -math.inf)
        return out

    return wrapper


class lazy_property:
    """Cache a derived quantity on first access."""

    def __init__(self, wrapped):
        self.wrapped = wrapped
        functools.update_wrapper(self, wrapped)

    def __get__(self, instance, obj_type=None):
        if instance is None:
            return self
        computed = self.wrapped(instance)
        instance.__dict__[self.wrapped.__name__] = computed
        return computed


def cholesky(x):
    """Lower Cholesky factor, batched.  Where a matrix is not positive
    definite its factor is NaN on and below the diagonal, as JAX's
    ``cholesky`` returns it, and so is the factor's derivative in the matrix
    (the NaN is ``nan * x``, not a constant); ``cholesky_ex`` reports that
    per matrix without a host sync (``cholesky`` would raise, after a sync
    on the GPU)."""
    factor, info = torch.linalg.cholesky_ex(x)
    ok = (info == 0)[..., None, None]
    poison = torch.where(ok, 0.0, math.nan).to(x.dtype)
    return torch.where(ok, factor, 0.0) + (poison * x).tril()


def inv(x):
    """The inverse, batched; a singular matrix gives the NaN and inf entries
    that JAX's LU-based ``inv`` gives, without raising (``inv_ex``, no host
    sync)."""
    return torch.linalg.inv_ex(x).inverse


def clamp_probs(probs):
    """Probabilities clipped into ``[tiny, 1 - eps]`` of their dtype."""
    info = torch.finfo(probs.dtype)
    return probs.clamp(min=info.tiny, max=1.0 - info.eps)


# ---------------------------------------------------------------------------
# Draws


def _uniform(key, shape, like):
    return torch.rand(shape, generator=key, device=key.device, dtype=like.dtype)


def _tiny_uniform(key, shape, like):
    return _uniform(key, shape, like).clamp(min=torch.finfo(like.dtype).tiny)


_STANDARD = {
    "normal": lambda key, shape, like: torch.randn(shape, generator=key, device=key.device,
                                                   dtype=like.dtype),
    "uniform": _uniform,
    "exponential": lambda key, shape, like: -torch.log1p(-_uniform(key, shape, like)),
    "gumbel": lambda key, shape, like: -torch.log(-torch.log(_tiny_uniform(key, shape, like))),
    "logistic": lambda key, shape, like: torch.logit(_tiny_uniform(key, shape, like)),
    "cauchy": lambda key, shape, like: torch.tan(math.pi * (_uniform(key, shape, like) - 0.5)),
}


def _laplace(key, shape, like):
    info = torch.finfo(like.dtype)
    u = (2.0 * _uniform(key, shape, like) - 1.0).clamp(min=-1.0 + info.eps)
    return -torch.sign(u) * torch.log1p(-u.abs())


_STANDARD["laplace"] = _laplace


def standard_draw(key, kind, shape, like):
    """Standard variates of ``kind`` (``normal``, ``uniform`` on [0, 1),
    ``exponential``, ``gumbel``, ``laplace``, ``logistic`` or ``cauchy``) of
    ``shape`` in the dtype of ``like``: from a generator on its device, or
    from a draw source's ``<kind>s(shape, like)``."""
    shape = tuple(shape)
    if isinstance(key, torch.Generator):
        return _STANDARD[kind](key, shape, like)
    return getattr(key, kind + "s")(shape, like)


# The gamma draw's derivative: a series of 48 terms summed 16 at a time, a
# continued fraction from its 32nd level up, and Temme's uniform expansion
# (6 orders in 1/a, each a polynomial of degree 19 in eta) from a = 20 up
# where |eta| <= 1: all but about 1e-5 of the draws at a = 20, fewer above.
_GAMMA_SERIES_DEPTH = 48
_GAMMA_SERIES_CHUNK = 16
_GAMMA_CF_DEPTH = 32
_TEMME_SHAPE = 20.0
_TEMME_ORDERS = 6
_TEMME_DEGREE = 20


def _series_product(p, q, n):
    out = [0] * n
    for i, pi in enumerate(p[:n]):
        for j, qj in enumerate(q[:n - i]):
            out[i + j] += pi * qj
    return out


def _series_inverse(p, n):
    out = [1 / p[0]]
    for m in range(1, n):
        out.append(-sum(p[i] * out[m - i] for i in range(1, min(m, len(p) - 1) + 1)) / p[0])
    return out


@functools.cache
def _temme_coefficients():
    """Taylor coefficients in eta of Temme's ``c_k(eta)``, ``k <`` 6, to
    degree 19, in exact rationals (DLMF 8.12.8-9): ``c_0 = 1/(lam - 1) -
    1/eta`` and ``c_k = c_{k-1}'(eta) / eta + (-1)^k g_k / (lam - 1)``,
    with ``lam = x / a``, ``eta^2 / 2 = lam - 1 - log(lam)`` (the sign of
    ``lam - 1``) and ``g_k`` the Stirling series' coefficients.  They are
    DiDonato and Morris's ``d_kn`` (Cephes ``igam``'s table)."""
    from fractions import Fraction

    order = _TEMME_DEGREE + 2 * _TEMME_ORDERS
    # (eta / mu)^2 as a series in mu = lam - 1, and its square root
    square = [Fraction(2 * (-1) ** j, j + 2) for j in range(order + 1)]
    root = [Fraction(1)]
    for m in range(1, order + 1):
        root.append((square[m] - sum(root[i] * root[m - i] for i in range(1, m))) / 2)
    # mu / eta as a series in eta, by Lagrange inversion of eta = mu * root(mu)
    w = _series_inverse(root, order + 1)
    power, mu_over_eta = [Fraction(1)], []
    for n in range(1, order + 2):
        power = _series_product(power, w, order + 1)
        mu_over_eta.append(power[n - 1] / n)
    eta_over_mu = _series_inverse(mu_over_eta, order + 1)
    bernoulli = [Fraction(1)]
    for m in range(1, 2 * _TEMME_ORDERS + 1):
        bernoulli.append(-sum(math.comb(m + 1, i) * bernoulli[i] for i in range(m)) / (m + 1))
    log_g = [Fraction(0)] * (_TEMME_ORDERS + 1)
    for i in range(1, _TEMME_ORDERS + 1, 2):
        log_g[i] = bernoulli[i + 1] / (i * (i + 1))
    g = [Fraction(1)]
    for m in range(1, _TEMME_ORDERS + 1):
        g.append(sum(i * log_g[i] * g[m - i] for i in range(1, m + 1)) / m)
    c = eta_over_mu[1:]
    rows = [c[:_TEMME_DEGREE]]
    for k in range(1, _TEMME_ORDERS):
        c = [(n + 2) * c[n + 2] + (-1) ** k * g[k] * eta_over_mu[n + 1]
             for n in range(len(c) - 2)]
        rows.append(c[:_TEMME_DEGREE])
    return tuple(tuple(float(v) for v in row) for row in rows)


@functools.cache
def _temme_table(device):
    """:func:`_temme_coefficients` on ``device``, copied there once (a copy
    to the card waits for its queue)."""
    return torch.tensor(_temme_coefficients(), dtype=torch.float64, device=device)


def _temme_derivative(a, x):
    """``dx/da`` of a gamma draw by Temme's uniform expansion (DLMF 8.12.3-4),
    ``Q(a, x) = erfc(eta sqrt(a / 2)) / 2 + exp(-a eta^2 / 2) / sqrt(2 pi a)
    * S``, ``S = sum_k c_k(eta) a^-k``, differentiated in ``a`` at fixed
    ``x`` and divided by the density ``x^(a-1) e^-x / Gamma(a)``, which
    leaves ``lam Gamma*(a) ((lam - 1)/eta - eta/2 + (log(lam) - 1/(2a)) S +
    dS/da)``.  ``Gamma*`` is Stirling's ratio.  Returns it with where it
    holds, ``|eta| <= 1`` (``eta`` is clipped to that), for ``a >= 20``;
    float64."""
    mu = (x - a) / a
    # eta^2 / 2 = mu - log1p(mu), by its Taylor series in mu (16 terms) where
    # that cancels, |mu| < 0.1
    j = torch.arange(16, dtype=torch.float64, device=x.device)
    taylor = (-1.0) ** j / (j + 2.0)
    small = (mu.clamp(-0.1, 0.1).unsqueeze(-1) ** j) @ taylor
    half = torch.where(mu.abs() < 0.1, small * mu * mu, mu - torch.log1p(mu))
    eta = torch.sign(mu) * torch.sqrt(half.clamp(min=0.0) * 2.0)
    inside = eta.abs() <= 1.0
    eta = eta.clamp(-1.0, 1.0)
    mu_over_eta = torch.where(eta == 0.0, 1.0, mu / torch.where(eta == 0.0, 1.0, eta))
    table = _temme_table(x.device)
    degree = torch.arange(_TEMME_DEGREE, dtype=torch.float64, device=x.device)
    powers = eta.unsqueeze(-1) ** degree
    # c_k(eta) and c_k'(eta), k < 6
    c = powers @ table.T
    dc = powers[..., :-1] @ (table[:, 1:] * degree[1:]).T
    k = torch.arange(_TEMME_ORDERS, dtype=torch.float64, device=x.device)
    a_k = a.unsqueeze(-1) ** -k
    deta_da = (-mu_over_eta / a).unsqueeze(-1)
    s = (c * a_k).sum(-1)
    ds = ((dc * deta_da - k * c / a.unsqueeze(-1)) * a_k).sum(-1)
    stirling = torch.exp(1.0 / (12.0 * a) - 1.0 / (360.0 * a**3) + 1.0 / (1260.0 * a**5))
    return (1.0 + mu) * stirling * (
        mu_over_eta - eta / 2.0 + (torch.log1p(mu) - 0.5 / a) * s + ds), inside


def _gamma_draw_derivative(a, x):
    """``dx/da`` of a standard gamma draw ``x`` of shape ``a``, the implicit
    derivative ``-(dP(a, x)/da) / density(x)``, in float64.  Below a = 20, or
    where ``|eta| > 1`` above, it is what XLA's ``RandomGammaGrad`` (JAX's
    ``random_gamma_grad``) computes: the series of ``P`` and its derivative
    in ``a`` for ``x < a + 1`` (48 terms, summed 16 at a time as cumulative
    products), the continued fraction of ``Q = 1 - P`` and its derivative
    above (Numerical Recipes 6.2.7, from depth 32 up, as ``betainc``'s).  The
    prefactor ``x^a e^-x / Gamma(a)`` cancels out of the ratio, so nothing
    underflows.  From a = 20 up, where the series would need about
    ``9 sqrt(a)`` terms near ``x = a`` and the fraction about ``sqrt(a)``
    levels, Temme's uniform expansion (:func:`_temme_derivative`) takes over.
    Fixed depths: no data-dependent loop and no host sync; about 450 tensor
    operations, and float64 temporaries of at most 20 columns at a time
    (about 1.1 KB an element at the peak of an SVI step's backward).

    Worst relative error against a Richardson-extrapolated central
    difference of scipy's float64 ``gammaincinv``, over 82 shapes a in
    [0.05, 1e5] and 120 quantiles from 1e-10 to 1 - 1e-10 each: 6.2e-10; at
    x / a from 0.01 to 20 against mpmath, 1.7e-11 (``python3 -m
    dev.gamma_derivative_accuracy``; ``tests/test_torch_gamma_grad.py``
    holds a grid to a = 1e6 at 1e-5 and the far points at 1e-9)."""
    a, x = a.to(torch.float64), x.to(torch.float64)
    a, x = torch.broadcast_tensors(a, x)
    log_x = torch.log(x)
    # series: P = x^a e^-x / Gamma(a + 1) * sum_n c_n, c_n = prod_k x / (a + k),
    # with its derivative in a carried by the harmonic sums h_n = sum_k 1/(a + k)
    log_c, h = torch.zeros_like(x), torch.zeros_like(x)
    total, d_total = torch.ones_like(x), torch.zeros_like(x)
    terms = torch.arange(1, _GAMMA_SERIES_DEPTH + 1, dtype=torch.float64, device=x.device)
    for k in terms.split(_GAMMA_SERIES_CHUNK):
        ak = a.unsqueeze(-1) + k
        log_ck = torch.cumsum(log_x.unsqueeze(-1) - torch.log(ak), -1) + log_c.unsqueeze(-1)
        hk = torch.cumsum(1.0 / ak, -1) + h.unsqueeze(-1)
        ck = torch.exp(log_ck)
        total = total + ck.sum(-1)
        d_total = d_total - (ck * hk).sum(-1)
        log_c, h = log_ck[..., -1], hk[..., -1]
    series = -(d_total + total * (log_x - torch.digamma(a + 1.0))) * x / a
    # continued fraction: Q = x^a e^-x / Gamma(a) / f, where
    # f = (x + 1 - a) - 1 (1 - a) / ((x + 3 - a) - 2 (2 - a) / ...)
    shift = x - a
    f = shift + (2 * _GAMMA_CF_DEPTH + 1)
    df = torch.full_like(f, -1.0)
    for j in range(_GAMMA_CF_DEPTH, 0, -1):
        ratio = torch.div((a - j).mul_(-j), f)
        f, df = torch.sub(shift, ratio).add_(2 * j - 1), (ratio * df).add_(j).div_(f).sub_(1.0)
    frac = (log_x - torch.digamma(a) - df / f) / f * x
    out = torch.where(x < a + 1.0, series, frac)
    temme, inside = _temme_derivative(a.clamp(min=_TEMME_SHAPE), x)
    out = torch.where((a >= _TEMME_SHAPE) & inside, temme, out)
    out = torch.where(x == 0.0, 0.0, out)
    bad = (x < 0.0) | (a <= 0.0) | torch.isnan(a) | torch.isnan(x)
    return torch.where(bad, math.nan, out)


def _draw_derivative(a, x):
    """:func:`_gamma_draw_derivative` on detached inputs: where a derivative
    is taken with ``create_graph`` (as ``torch.func.grad`` takes it), no graph
    of its 450 steps and their float64 temporaries is kept.  Differentiating
    it again raises, as JAX's ``random_gamma_grad`` and ``igamma_grad_a``
    have no derivative either."""
    value = _gamma_draw_derivative(a.detach(), x.detach())
    return _NoDerivative.apply(value, "the gamma draw's derivative dx/da",
                               "JAX's random_gamma_grad has none either", a, x)


class _GammaDraw(torch.autograd.Function):
    """A standard gamma draw of shape ``alpha``, made without a derivative
    (``torch._standard_gamma`` on the detached shape, or a draw source's),
    given its implicit reparameterised derivative ``dx/dalpha``
    (:func:`_draw_derivative`) in reverse and in forward mode."""

    generate_vmap_rule = True

    @staticmethod
    def forward(alpha, draw):
        return draw.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        alpha, draw = ctx.saved_tensors
        return grad * _draw_derivative(alpha, draw).to(grad.dtype), None

    @staticmethod
    def jvp(ctx, alpha_t, draw_t):
        alpha, draw = ctx.saved_tensors
        return alpha_t * _draw_derivative(alpha, draw).to(alpha_t.dtype)


def standard_gamma(key, alpha):
    """Standard gamma draws of shape ``alpha`` (``alpha`` broadcast to the
    draws' shape), reparameterised in ``alpha`` in reverse and forward mode
    (:class:`_GammaDraw`): ``torch._standard_gamma`` from a generator (one
    value per element under ``torch.func.vmap(randomness="different")``), or
    a draw source's ``gammas(alpha)``."""
    if not isinstance(key, torch.Generator):
        return _GammaDraw.apply(alpha, key.gammas(alpha).to(alpha.dtype))
    alpha = alpha.to(key.device)
    return _GammaDraw.apply(alpha, torch._standard_gamma(alpha.detach(), generator=key))


def _on_key(key, *tensors):
    """The tensors, detached and on the generator's device (a count or an
    angle carries no derivative); unchanged for a draw source."""
    if not isinstance(key, torch.Generator):
        return tensors
    return tuple(t.detach().to(key.device) for t in tensors)


def binomial(key, p, n=1, shape=()):
    """Binomial(``n``, ``p``) counts of ``shape`` (by default the broadcast
    of ``p`` and ``n``), as floats in the dtype of ``p``.  From a generator:
    ``torch.binomial`` on ``min(p, 1 - p)``, mirrored back where ``p > 0.5``,
    as the JAX package's ``_binomial`` does, with a NaN ``p`` or ``n <= 0``
    giving 0 before the mirror (so ``p = 1`` gives ``n``).  ``torch.binomial``
    takes ``n`` and ``p`` of one shape, so both are broadcast first (under
    ``vmap`` it would warn and resize otherwise).  A draw source hands in
    whole draws, ``binomials(n, p)``."""
    p, n = _promote(p, n)
    shape = tuple(shape) or tuple(p.shape)
    dtype = p.dtype if p.is_floating_point() else torch.get_default_dtype()
    p, n = _on_key(key, p.to(dtype).expand(shape), n.to(dtype).expand(shape))
    if not isinstance(key, torch.Generator):
        return key.binomials(n, p).to(dtype)
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    # ~(q > 0) also catches a NaN p
    degenerate = ~(q > 0.0) | (n <= 0.0)
    q_safe = torch.where(degenerate, 0.25, q)
    # under vmap a count captured from outside the map is not batched where
    # the probability is, and torch.binomial then warns and resizes: the
    # zeros give the count the probability's batch
    n_safe = torch.where(n <= 0.0, 1.0, n) + torch.zeros_like(q_safe)
    k = torch.binomial(n_safe.contiguous(), q_safe.contiguous(), generator=key)
    k = torch.where(degenerate, 0.0, k)
    return torch.where(flip, n - k, k)


def poisson(key, rate, shape=()):
    """Poisson(``rate``) counts of ``shape`` (by default ``rate``'s), as
    floats in the dtype of ``rate``: ``torch.poisson`` from a generator, or a
    draw source's ``poissons(rate)``."""
    shape = tuple(shape) or tuple(rate.shape)
    (rate,) = _on_key(key, rate.expand(shape))
    if not isinstance(key, torch.Generator):
        return key.poissons(rate).to(rate.dtype)
    return torch.poisson(rate.contiguous(), generator=key)


def categorical(key, p, shape=()):
    """Category indices of ``shape`` (by default ``p``'s batch shape) by
    inverting the CDF of ``p`` on uniform draws, as the JAX package's
    ``categorical`` does (so JAX's uniforms give JAX's indices)."""
    shape = tuple(shape) or tuple(p.shape[:-1])
    (p,) = _on_key(key, p)
    cdf = torch.cumsum(p, -1)
    u = standard_draw(key, "uniform", shape + (1,), p)
    return (cdf < u * cdf[..., -1:]).sum(-1)


def multinomial(key, p, n, shape=(), total_count_max=None):
    """Multinomial(``n``, ``p``) counts of ``shape + p.shape[-1:]`` as
    ``int64``: ``n_max`` categorical draws, one-hot summed under a per-trial
    mask, as in the JAX package.  ``n_max`` is ``total_count_max``, or else
    the largest ``n``, read once on the host; a ``n`` batched under ``vmap``
    cannot be read there, and then ``total_count_max`` is required."""
    if total_count_max is None:
        try:
            n_max = int(n.max())
        except RuntimeError:
            raise ValueError("total_count_max is required when total_count is traced") from None
    else:
        n_max = int(total_count_max)
    k = p.shape[-1]
    shape = tuple(shape) or broadcast_shape(tuple(p.shape[:-1]), tuple(n.shape))
    if n_max == 0:
        return torch.zeros(shape + (k,), dtype=torch.int64, device=p.device)
    draws = categorical(key, p, (n_max,) + shape)
    trial = torch.arange(n_max, device=draws.device).reshape((n_max,) + (1,) * len(shape))
    live = trial < n.to(draws.device).expand(shape)
    onehot = draws.unsqueeze(-1) == torch.arange(k, device=draws.device)
    return (onehot & live.unsqueeze(-1)).sum(0)


# the rounds of the von Mises rejection sampler, drawn at once: Best and
# Fisher's envelope accepts a proposal with probability at least 0.656 for
# every concentration (0.6575 measured at 1e5, its limit), so a lane is
# unsettled after 44 rounds with probability below 0.344^44 = 4e-21, and
# any of 1e8 draws below 1e-12
VON_MISES_ROUNDS = 44
# below these concentrations the envelope's exact parameter loses its digits,
# and 1 / kappa replaces it (the JAX package's thresholds)
_VON_MISES_CUT = {torch.float16: 1.8e-1, torch.float32: 2e-2, torch.float64: 1.2e-4}


def von_mises_centered(key, concentration, shape=(), dtype=None):
    """Von Mises draws about 0 of ``shape`` (by default ``concentration``'s),
    by Best and Fisher's (1979) wrapped-Cauchy rejection, as the JAX
    package's sampler makes them, with its per-dtype thresholds and a
    Rademacher sign.  Where JAX loops until every lane accepts, this draws
    ``VON_MISES_ROUNDS`` proposals per lane at once and takes the first
    accepted one: no data-dependent loop, no host sync, and it runs under
    ``vmap``.  A lane with no accepted proposal (probability below 4e-21)
    gives NaN, never a rejected proposal.  A draw source hands in centred
    draws, ``von_mises(concentration)``."""
    dtype = dtype or (concentration.dtype if concentration.is_floating_point()
                      else torch.get_default_dtype())
    shape = tuple(shape) or tuple(concentration.shape)
    (kappa,) = _on_key(key, concentration.to(dtype).expand(shape))
    if not isinstance(key, torch.Generator):
        return key.von_mises(kappa).to(dtype)
    cut = _VON_MISES_CUT.get(dtype, 2e-2)
    r = 1.0 + torch.sqrt(1.0 + 4.0 * kappa.square())
    rho = (r - torch.sqrt(2.0 * r)) / (2.0 * kappa)
    env = torch.where(kappa > cut, (1.0 + rho.square()) / (2.0 * rho),
                      1.0 / kappa.clamp(min=torch.finfo(dtype).tiny))
    u, v = torch.rand((2, VON_MISES_ROUNDS) + shape, generator=key, device=key.device,
                      dtype=dtype)
    z = torch.cos(math.pi * u)
    w = (1.0 + env * z) / (env + z)
    y = kappa * (env - w)
    ok = (y * (2.0 - y) >= v) | (torch.log((y / v).clamp(min=1e-37)) + 1.0 >= y)
    w = _first_accepted(ok, w)
    sign = torch.where(torch.rand(shape, generator=key, device=key.device, dtype=dtype) < 0.5,
                       -1.0, 1.0)
    return sign * torch.arccos(w.clamp(-1.0, 1.0))


def _first_accepted(ok, proposals):
    """The first accepted proposal along the leading (rounds) axis, NaN where
    none was accepted."""
    first = torch.argmax(ok.to(torch.uint8), 0, keepdim=True)
    picked = torch.gather(proposals, 0, first).squeeze(0)
    return torch.where(ok.any(0), picked, math.nan)


def safe_normalize(x, *, p=2):
    """``x`` over its ``p``-norm along the last axis; the zero vector maps
    to the uniform direction with a zero derivative (the double ``where`` of
    the JAX package keeps the norm's 0/0 out of the backward pass)."""
    zero = (x == 0).all(-1, keepdim=True)
    x_safe = torch.where(zero, 1.0, x)
    norm = torch.linalg.vector_norm(x_safe, p, dim=-1, keepdim=True)
    unit = x_safe / norm.clamp(min=torch.finfo(x.dtype).tiny)
    return torch.where(zero, x.shape[-1] ** (-1.0 / p), unit)


# ---------------------------------------------------------------------------
# Special functions


def betaln(a, b):
    """``log B(a, b)`` through ``lgamma`` in float64, returned in the dtype of
    the inputs: in float32 the difference of ``lgamma`` values of a few
    thousand loses the digits the JAX package's ``betaln`` keeps."""
    a, b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b))
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    return (torch.lgamma(a64) + torch.lgamma(b64) - torch.lgamma(a64 + b64)).to(a.dtype)


# depth of betainc's continued fraction: at 40 its error is below 2e-11 for
# a and b in [0.1, 1000] against scipy in float64 (and 3e-13 below 100)
_BETAINC_DEPTH = 40


def _betainc_forward(a, b, x):
    """``I_x(a, b)`` in float64 by the continued fraction of Numerical
    Recipes (6.4.5), on the side of the mean where it converges fast
    (``I_x(a, b) = 1 - I_{1-x}(b, a)``), evaluated from its tail at a fixed
    depth."""
    swap = x > (a + 1.0) / (a + b + 2.0)
    p, q, y = torch.where(swap, b, a), torch.where(swap, a, b), torch.where(swap, 1.0 - x, x)
    m = torch.arange(1, _BETAINC_DEPTH + 1, dtype=torch.float64, device=x.device)
    m = m.reshape((-1,) + (1,) * p.dim())
    even = m * (q - m) * y / ((p + 2.0 * m - 1.0) * (p + 2.0 * m))
    odd = -(p + m) * (p + q + m) * y / ((p + 2.0 * m) * (p + 2.0 * m + 1.0))
    first = -(p + q) * y / (p + 1.0)
    one = torch.ones_like(y)
    frac = one
    for k in range(_BETAINC_DEPTH - 1, -1, -1):
        frac = torch.addcdiv(one, odd[k], frac)
        frac = torch.addcdiv(one, even[k], frac)
    frac = torch.addcdiv(one, first, frac)
    log_front = torch.xlogy(p, y) + torch.special.xlog1py(q, -y) - torch.log(p) - (
        torch.lgamma(p) + torch.lgamma(q) - torch.lgamma(p + q))
    tail = torch.exp(log_front) / frac
    out = torch.where(swap, 1.0 - tail, tail)
    out = torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, out))
    bad = (a <= 0.0) | (b <= 0.0) | (x < 0.0) | (x > 1.0) | torch.isnan(x)
    return torch.where(bad, math.nan, out)


def _beta_density(a, b, x):
    return torch.exp(torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x) - betaln(a, b))


class _Betainc(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, x):
        out = _betainc_forward(a.to(torch.float64), b.to(torch.float64), x.to(torch.float64))
        return out.to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError(
                "Betainc gradient with respect to a and b not supported (as in the JAX package)."
            )
        return None, None, grad * _beta_density(a, b, x)

    @staticmethod
    def jvp(ctx, a_t, b_t, x_t):
        raise NotImplementedError("betainc has no forward-mode derivative in numpyro_tpu_torch")


def _promote(*args):
    like = next((v for v in args if isinstance(v, torch.Tensor)), None)
    kw = {"dtype": like.dtype, "device": like.device} if like is not None and \
        like.is_floating_point() else {"dtype": torch.get_default_dtype()}
    return torch.broadcast_tensors(*(
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, **kw) for v in args))


def betainc(a, b, x):
    """The regularized incomplete beta function ``I_x(a, b)``; its derivative
    in ``x`` is the Beta density, and a derivative in ``a`` or ``b`` raises
    ``ValueError``, as the JAX package's ``betainc`` does."""
    return _Betainc.apply(*_promote(a, b, x))


def _gamma_density(a, x):
    return torch.exp(torch.xlogy(a - 1.0, x) - x - torch.lgamma(a))


class _Gammainc(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        # float64 inside: PyTorch's float32 gammainc is 1e-5 relative off
        return torch.special.gammainc(a.to(torch.float64), x.to(torch.float64)).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def _partials(ctx, wants_a):
        """``dP/da`` (when ``wants_a``) and ``dP/dx``, in the dtype of ``x``:
        ``dP/dx`` is the density, in that dtype as the JAX package takes it;
        ``dP/da = -density(x) dx/da`` in float64, with the draw's derivative
        of :func:`_gamma_draw_derivative`."""
        a, x = ctx.saved_tensors
        d_a = None
        if wants_a:
            a64, x64 = a.to(torch.float64), x.to(torch.float64)
            d_a = (-_gamma_density(a64, x64) * _draw_derivative(a64, x64)).to(x.dtype)
        return d_a, _gamma_density(a, x)

    @staticmethod
    def backward(ctx, grad):
        d_a, d_x = _Gammainc._partials(ctx, ctx.needs_input_grad[0])
        return (None if d_a is None else grad * d_a), grad * d_x

    @staticmethod
    def jvp(ctx, a_t, x_t):
        d_a, d_x = _Gammainc._partials(ctx, a_t is not None)
        out = 0.0 if x_t is None else x_t * d_x
        return out if a_t is None else out + a_t * d_a


def gammainc(a, x):
    """The regularized lower incomplete gamma function ``P(a, x)``, with
    derivatives in ``x`` and in ``a`` (PyTorch's ``gammainc`` has the first
    only), in reverse and forward mode.  The derivative in ``a`` is
    ``-density(x)`` times the gamma draw's ``dx/da``
    (:func:`_gamma_draw_derivative`)."""
    return _Gammainc.apply(*_promote(a, x))


def _bisect_inverse(fn, target, lo, hi, iters):
    """Invert a monotone CDF by fixed-count bisection (no data-dependent
    loop: the trip count is fixed and the bracket is whole-tensor)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = fn(mid) < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


_BISECTION = "the JAX package's fixed-count bisection gives a silent zero there (see ROADMAP.md)"


class _NoDerivative(torch.autograd.Function):
    """The identity on a value computed without a derivative: any
    derivative through it raises, naming ``name`` and why."""

    generate_vmap_rule = True

    @staticmethod
    def forward(value, name, why, *inputs):
        return value.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name, ctx.why = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(f"{ctx.name} has no derivative in numpyro_tpu_torch: {ctx.why}")

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(f"{ctx.name} has no derivative in numpyro_tpu_torch")


def betaincinv(a, b, y):
    """The inverse of ``betainc`` in ``x``, by 60 bisection steps on [0, 1]."""
    a, b, y = _promote(a, b, y)
    with torch.no_grad():
        value = _bisect_inverse(lambda x: betainc(a, b, x), y, torch.zeros_like(y),
                                torch.ones_like(y), 60)
    return _NoDerivative.apply(value, "betaincinv", _BISECTION, a, b, y)


def gammaincinv(a, y):
    """The inverse of ``gammainc`` in ``x``, by 120 bisection steps on
    [0, 1e6]."""
    a, y = _promote(a, y)
    with torch.no_grad():
        value = _bisect_inverse(lambda x: gammainc(a, x), y, torch.zeros_like(y),
                                torch.full_like(y, 1e6), 120)
    return _NoDerivative.apply(value, "gammaincinv", _BISECTION, a, y)

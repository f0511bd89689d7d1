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
``cauchys``, and ``gammas(alpha)``), through which tests hand the port the JAX
package's draws.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = [
    "betainc", "betaincinv", "betaln", "broadcast_shape", "cholesky", "cholesky_update",
    "clamp_probs", "gammainc", "gammaincinv", "lazy_property", "logmatmulexp",
    "promote_shapes", "scale_and_mask", "standard_draw", "standard_gamma", "sum_rightmost",
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


def clamp_probs(probs):
    """Probabilities clipped into ``[tiny, 1 - eps]`` of their dtype."""
    info = torch.finfo(probs.dtype)
    return probs.clamp(min=info.tiny, max=1.0 - info.eps)


# ---------------------------------------------------------------------------
# Draws


class ForwardModeDrawError(NotImplementedError):
    """A draw whose parameters carry a forward-mode tangent: PyTorch's gamma
    sampler has no forward-mode derivative.  The ``sample`` primitive adds the
    name of the site."""


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


class _FedGamma(torch.autograd.Function):
    """A gamma draw handed in by a draw source, with the implicit
    reparameterised derivative in the shape that ``torch._standard_gamma``
    gives its own draws (``_standard_gamma_grad``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(alpha, draw):
        return draw.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        alpha, draw = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, draw), None


def standard_gamma(key, alpha):
    """Standard gamma draws of shape ``alpha`` (``alpha`` broadcast to the
    draws' shape), reparameterised in ``alpha``: ``torch._standard_gamma``
    from a generator (one value per element under ``torch.func.vmap(
    randomness="different")``), or a draw source's ``gammas(alpha)``."""
    if not isinstance(key, torch.Generator):
        return _FedGamma.apply(alpha, key.gammas(alpha).to(alpha.dtype))
    try:
        return torch._standard_gamma(alpha.to(key.device), generator=key)
    except NotImplementedError as e:
        if "forward AD" not in str(e):
            raise
        raise ForwardModeDrawError(
            "a gamma draw (Gamma, Chi2, InverseGamma, Beta, Dirichlet, StudentT) has no "
            "forward-mode derivative in PyTorch; differentiate this model in reverse mode"
        ) from None


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


class _Gammainc(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        # float64 inside: PyTorch's float32 gammainc is 1e-5 relative off
        return torch.special.gammainc(a.to(torch.float64), x.to(torch.float64)).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        density = torch.exp(torch.xlogy(a - 1.0, x) - x - torch.lgamma(a))
        # the implicit derivative of a standard gamma draw x in its shape a is
        # -(dP/da) / density(x), which ``_standard_gamma_grad`` computes
        grad_a = -torch._standard_gamma_grad(a, x) * density if ctx.needs_input_grad[0] else None
        return (None if grad_a is None else grad * grad_a), grad * density

    @staticmethod
    def jvp(ctx, a_t, x_t):
        raise NotImplementedError("gammainc has no forward-mode derivative in numpyro_tpu_torch")


def gammainc(a, x):
    """The regularized lower incomplete gamma function ``P(a, x)``, with
    derivatives in ``x`` and in ``a`` (PyTorch's ``gammainc`` has the first
    only).  The second comes from ``torch._standard_gamma_grad``, a rational
    approximation up to 4e-4 relative off the exact derivative, which the JAX
    package's is within 2e-6 of."""
    return _Gammainc.apply(*_promote(a, x))


def _bisect_inverse(fn, target, lo, hi, iters):
    """Invert a monotone CDF by fixed-count bisection (no data-dependent
    loop: the trip count is fixed and the bracket is whole-tensor)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = fn(mid) < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


class _NoDerivative(torch.autograd.Function):
    """The identity on a value computed without a derivative: any
    derivative through it raises (the JAX package's bisection gives a silent
    zero there)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(value, name, *inputs):
        return value.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"{ctx.name} has no derivative in numpyro_tpu_torch: the JAX package's "
            "fixed-count bisection gives a silent zero there (see ROADMAP.md)"
        )

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(f"{ctx.name} has no derivative in numpyro_tpu_torch")


def betaincinv(a, b, y):
    """The inverse of ``betainc`` in ``x``, by 60 bisection steps on [0, 1]."""
    a, b, y = _promote(a, b, y)
    with torch.no_grad():
        value = _bisect_inverse(lambda x: betainc(a, b, x), y, torch.zeros_like(y),
                                torch.ones_like(y), 60)
    return _NoDerivative.apply(value, "betaincinv", a, b, y)


def gammaincinv(a, y):
    """The inverse of ``gammainc`` in ``x``, by 120 bisection steps on
    [0, 1e6]."""
    a, y = _promote(a, y)
    with torch.no_grad():
        value = _bisect_inverse(lambda x: gammainc(a, x), y, torch.zeros_like(y),
                                torch.full_like(y, 1e6), 120)
    return _NoDerivative.apply(value, "gammaincinv", a, y)

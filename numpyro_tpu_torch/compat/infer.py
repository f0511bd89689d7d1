"""Pyro-flavoured inference constructors (port of
``numpyro_tpu/compat/infer.py``).

Pyro's classes take a wider keyword surface than the port's; each shim here
is built from a declarative spec, as in the JAX package: which Pyro
keywords map onto which native keywords, and which are Pyro-only noise to
swallow.  The drivers run on the card unless given ``device``, as the
port's own do; an ``rng_key`` is an int seed or a ``torch.Generator`` on the
run's device.
"""

import math

from numpyro_tpu_torch.infer import elbo as _elbo
from numpyro_tpu_torch.infer import hmc as _hmc
from numpyro_tpu_torch.infer import mcmc as _mcmc
from numpyro_tpu_torch.infer import svi as _svi

# Pyro keywords accepted and discarded
_TORCH_ONLY = (
    "use_multinomial_sampling",
    "transforms",
    "max_plate_nesting",
    "jit_compile",
    "jit_options",
    "ignore_jit_warnings",
)


def _shim(native_cls, renames, swallow, defaults):
    """Build an ``__init__`` that renames and filters Pyro's keywords, then
    defers to ``native_cls``."""

    def __init__(self, *args, **kwargs):
        merged = dict(defaults)
        merged.update(kwargs)
        native = {}
        for key, val in merged.items():
            if key in swallow:
                continue
            native[renames.get(key, key)] = val
        native_cls.__init__(self, *args, **native)

    return __init__


class HMC(_hmc.HMC):
    __init__ = _shim(
        _hmc.HMC,
        renames={"full_mass": "dense_mass"},
        swallow=_TORCH_ONLY,
        defaults={"step_size": 1, "trajectory_length": 2 * math.pi},
    )


class NUTS(_hmc.NUTS):
    __init__ = _shim(
        _hmc.NUTS,
        renames={"full_mass": "dense_mass"},
        swallow=_TORCH_ONLY + ("trajectory_length",),
        defaults={"step_size": 1},
    )


class MCMC:
    """Pyro-shaped driver facade over :class:`numpyro_tpu_torch.infer.MCMC`
    (``device=None`` is the card)."""

    def __init__(self, kernel, num_samples, warmup_steps=None, **kwargs):
        self._initial_params = kwargs.pop("initial_params", None)
        progbar = not kwargs.pop("disable_progbar", False)
        self._mcmc = _mcmc.MCMC(
            kernel,
            num_warmup=num_samples if warmup_steps is None else warmup_steps,
            num_samples=num_samples,
            num_chains=kwargs.pop("num_chains", 1),
            progress_bar=progbar,
            device=kwargs.pop("device", None),
        )

    def run(self, rng_key, *args, **kwargs):
        kwargs.setdefault("init_params", self._initial_params)
        self._mcmc.run(rng_key, *args, **kwargs)

    def get_samples(self, num_samples=None, group_by_chain=False):
        if num_samples is not None:
            raise ValueError("subsetting draws is a torch-pyro feature")
        return self._mcmc.get_samples(group_by_chain=group_by_chain)

    def summary(self, prob=0.9):
        self._mcmc.print_summary(prob=prob)


class SVI(_svi.SVI):
    """Stateful (Pyro-style) facade over the functional SVI: the state lives
    on the object and ``step`` threads it.  ``device=None`` is the card;
    Pyro's other keywords are ignored."""

    def __init__(self, model, guide, optim, loss, device=None, **_ignored):
        super().__init__(model=model, guide=guide, optim=optim, loss=loss, device=device)
        self.svi_state = None

    def step(self, *args, rng_key=None, **kwargs):
        if self.svi_state is None:
            if rng_key is None:
                raise ValueError("the first step() needs an rng_key")
            self.svi_state = self.init(rng_key, *args, **kwargs)
        self.svi_state, loss = self.update(self.svi_state, *args, **kwargs)
        return loss

    def evaluate_loss(self, *args, **kwargs):
        return self.evaluate(self.svi_state, *args, **kwargs)

    def get_params(self, svi_state=None):
        """The constrained params of the object's state (or of
        ``svi_state``, so that ``evaluate`` can call it, where the JAX
        package's override takes no state and ``evaluate_loss`` raises)."""
        return super().get_params(self.svi_state if svi_state is None else svi_state)


class Trace_ELBO(_elbo.Trace_ELBO):
    __init__ = _shim(
        _elbo.Trace_ELBO,
        renames={},
        swallow=_TORCH_ONLY
        + (
            "max_iarange_nesting",
            "vectorize_particles",
            "strict_enumeration_warning",
            "retain_graph",
            "tail_adaptive_beta",
        ),
        defaults={},
    )


# the port runs the same steps whatever Pyro's Jit* spelling says
JitTrace_ELBO = Trace_ELBO

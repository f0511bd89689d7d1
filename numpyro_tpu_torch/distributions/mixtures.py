"""Finite mixtures (port of ``numpyro_tpu/distributions/mixtures.py``):
``Mixture``, ``MixtureSameFamily`` (one component distribution batched along
its last batch axis) and ``MixtureGeneral`` (a list of components).

``log_prob`` is a ``logsumexp`` over the component axis.  A draw takes every
component's draw first, then the mixing ``Categorical``'s (its Gumbel draws
go through the draw source, so a test can hand in the JAX package's), and
keeps the chosen component's value with ``torch.gather``, where the JAX
package contracts with a one-hot vector: the values are the same.
"""

from __future__ import annotations

import torch

from .discrete import CategoricalLogits, CategoricalProbs
from .distribution import Distribution

__all__ = ["Mixture", "MixtureGeneral", "MixtureSameFamily"]


def Mixture(mixing_distribution, component_distributions, *, validate_args=None):
    """A :class:`MixtureSameFamily` for one batched component distribution,
    a :class:`MixtureGeneral` for a list of them."""
    cls = (MixtureSameFamily if isinstance(component_distributions, Distribution)
           else MixtureGeneral)
    return cls(mixing_distribution, component_distributions, validate_args=validate_args)


def _require_categorical(mixing_distribution):
    if not isinstance(mixing_distribution, (CategoricalLogits, CategoricalProbs)):
        raise ValueError("The mixing distribution must be a Categorical distribution; got "
                         f"{type(mixing_distribution)}")
    return mixing_distribution._param().shape[-1]


class _MixtureBase(Distribution):
    """The mixture algebra over the stacked components, whose axis is
    ``mixture_dim``; a subclass gives ``component_log_probs``,
    ``component_sample`` and the stacked ``component_mean`` and
    ``component_variance``."""

    arg_constraints = {}
    has_rsample = True

    @property
    def mixture_size(self):
        return self._mixture_size

    @property
    def mixing_distribution(self):
        return self._mixing_distribution

    @property
    def mixture_dim(self):
        return -self.event_dim - 1

    def component_log_probs(self, value):
        raise NotImplementedError(f"{type(self).__name__}.component_log_probs")

    def component_sample(self, key, sample_shape=()):
        raise NotImplementedError(f"{type(self).__name__}.component_sample")

    def _weights_for_events(self):
        w = self.mixing_distribution.probs
        return w.reshape(tuple(w.shape) + (1,) * self.event_dim)

    @property
    def mean(self):
        return (self._weights_for_events() * self.component_mean).sum(self.mixture_dim)

    @property
    def variance(self):
        w = self._weights_for_events()
        # the law of total variance: E[var | k] + var[mean | k]
        within = (w * self.component_variance).sum(self.mixture_dim)
        centered = self.component_mean - self.mean.unsqueeze(self.mixture_dim)
        return within + (w * centered.square()).sum(self.mixture_dim)

    def sample_with_intermediates(self, key, sample_shape=()):
        sample_shape = tuple(sample_shape)
        stacked = self.component_sample(key, sample_shape)
        picks = self.mixing_distribution.expand(sample_shape + self.batch_shape).sample(key)
        index = picks.reshape(tuple(picks.shape) + (1,) * (self.event_dim + 1))
        index = index.expand(tuple(picks.shape) + (1,) + self.event_shape)
        chosen = torch.gather(stacked, self.mixture_dim, index).squeeze(self.mixture_dim)
        return chosen, [picks]

    def sample(self, key, sample_shape=()):
        return self.sample_with_intermediates(key, sample_shape)[0]

    def log_prob(self, value, intermediates=None):
        return torch.logsumexp(self.component_log_probs(value), -1)

    def _log_weights(self):
        return torch.log_softmax(self.mixing_distribution.logits, -1)


class MixtureSameFamily(_MixtureBase):
    """A mixture whose components are one distribution batched along its
    last batch axis."""

    def __init__(self, mixing_distribution, component_distribution, *, validate_args=None):
        k = _require_categorical(mixing_distribution)
        if not isinstance(component_distribution, Distribution):
            raise ValueError(
                "The component distribution need to be a "
                "numpyro_tpu_torch.distributions.Distribution. "
                f"However, it is of type {type(component_distribution)}")
        if component_distribution.batch_shape[-1] != k:
            raise ValueError(
                "Component distribution batch shape last dimension "
                f"(size={component_distribution.batch_shape[-1]}) "
                f"needs to correspond to the mixture_size={k}!")
        self._mixing_distribution = mixing_distribution
        self._component_distribution = component_distribution
        self._mixture_size = k
        super().__init__(component_distribution.batch_shape[:-1],
                         component_distribution.event_shape, validate_args=validate_args)

    @property
    def component_distribution(self):
        return self._component_distribution

    @property
    def support(self):
        return self._component_distribution.support

    @property
    def is_discrete(self):
        return self._component_distribution.is_discrete

    @property
    def component_mean(self):
        return self._component_distribution.mean

    @property
    def component_variance(self):
        return self._component_distribution.variance

    def cdf(self, samples):
        per_component = self._component_distribution.cdf(samples.unsqueeze(self.mixture_dim))
        return (per_component * self.mixing_distribution.probs).sum(-1)

    def component_sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + (self.mixture_size,)
        return self._component_distribution.expand(shape).sample(key)

    def component_log_probs(self, value):
        lps = self._component_distribution.log_prob(value.unsqueeze(self.mixture_dim))
        return self._log_weights() + lps


class MixtureGeneral(_MixtureBase):
    """A mixture of a list of component distributions of one batch shape,
    event shape and support (or an explicit ``support``)."""

    def __init__(self, mixing_distribution, component_distributions, *, support=None,
                 validate_args=None):
        k = _require_categorical(mixing_distribution)
        self._mixing_distribution = mixing_distribution
        self._mixture_size = k
        try:
            components = list(component_distributions)
        except TypeError:
            raise ValueError("The 'component_distributions' argument must be a list of "
                             "Distribution objects")
        if any(not isinstance(d, Distribution) for d in components):
            raise ValueError("All elements of 'component_distributions' must be instances of "
                             "numpyro_tpu_torch.distributions.Distribution subclasses")
        if len(components) != k:
            raise ValueError(
                "The number of elements in 'component_distributions' needs to match the "
                f"mixture_size of the mixing_distribution ({len(components)} != {k})")
        self._component_distributions = components
        if support is None:
            support = components[0].support
            if any(d.support is not support for d in components[1:]):
                raise ValueError("All component distributions must have the same support "
                                 "(or pass `support` explicitly).")
        self._support = support
        super().__init__(components[0].batch_shape, components[0].event_shape,
                         validate_args=validate_args)

    @property
    def component_distributions(self):
        return self._component_distributions

    @property
    def support(self):
        return self._support

    @property
    def is_discrete(self):
        return self._support.is_discrete

    def _stack(self, values):
        return torch.stack(values, self.mixture_dim)

    @property
    def component_mean(self):
        return self._stack([d.mean for d in self._component_distributions])

    @property
    def component_variance(self):
        return self._stack([d.variance for d in self._component_distributions])

    def cdf(self, samples):
        stacked = self._stack([d.cdf(samples) for d in self._component_distributions])
        return (stacked * self.mixing_distribution.probs).sum(-1)

    def component_sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self._stack([d.expand(shape).sample(key) for d in self._component_distributions])

    def component_log_probs(self, value):
        lps = torch.stack([d.log_prob(value) for d in self._component_distributions], -1)
        return self._log_weights() + lps

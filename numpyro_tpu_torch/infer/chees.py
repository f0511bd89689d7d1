"""ChEES-HMC, chain-massive HMC with cross-chain trajectory adaptation (port
of ``numpyro_tpu/infer/chees.py``).

Hoffman, Radul & Sountsov (AISTATS 2021).  Every chain takes the same number
of leapfrog steps in a transition, a Halton-jittered fraction of one learned
trajectory length, so a batched evaluation never waits for the deepest tree
of the batch as NUTS does.  The trajectory length follows Adam on the ChEES
criterion, the step size dual averaging on the accept probability, and the
diagonal mass a Welford estimate, all pooled over the chain batch.

The whole ``(C, D)`` panel goes through one batched potential evaluation a
leapfrog step (``infer.util.batched_value_and_grad``): on covtype that is
one ``glm_split`` launch for all chains.

What differs from the JAX kernel:

- The number of leapfrog steps is read on the host once a transition (one
  sync; ``lax.fori_loop`` takes a traced bound in JAX).  The adaptation stays
  on the device: its choices are ``torch.where`` on 0-dim tensors, and the
  step index ``i`` is a host integer.
- The proposal's potential is the last leapfrog step's value, where JAX
  evaluates it once more (``pe_prop``): the same numbers with one evaluation
  less, ``num_steps + 1`` a transition (ROADMAP.md, Queue 3).
- Draws come from the state's draw source (``hmc_core.GeneratorDraws``), in
  this order a transition: ``normals((C, D))`` (the momentum) and
  ``uniforms((C,))`` (the accept test).  ``init`` draws through the init
  search of ``initialize_model`` from the source's generator.

Under ``chain_method="parallel"`` each rank holds its rows of the chain
panel (``hmc_core.ShardedDraws``) and runs their leapfrog steps.  What
couples the chains, the warmup adaptation's cross-chain means, the Welford
merge and the pooled accept probability, runs on the whole panel: a warmup
transition gathers its positions, proposals, momenta, accept probabilities
and divergences over the chain group in one exact ``all_reduce``
(``parallel.mesh.gather_rows``), and every rank adapts alike.  The run equals
the one-process run bit for bit where a chain's potential does not depend on
how many chains share its batch.
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial

import torch

from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_core import FlatLayout
from numpyro_tpu_torch.infer.hmc_util import DualAveragingState, dual_averaging
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.infer.mcmc import MCMCKernel
from numpyro_tpu_torch.infer.util import ParamInfo, initialize_model
from numpyro_tpu_torch.util import identity, tree_map

__all__ = ["CheesAdaptState", "CheesHMC", "CheesHMCState", "chees_state_from_numpy"]

CheesAdaptState = namedtuple(
    "CheesAdaptState",
    [
        "step_size",
        "inverse_mass_matrix",  # diagonal, (D,)
        "trajectory_length",
        "da_state",  # DualAveragingState over the log step size
        "tl_state",  # _AdamState over the log trajectory length
        "wf_mean",
        "wf_m2",
        "wf_n",
    ],
)

CheesHMCState = namedtuple(
    "CheesHMCState",
    [
        "i",
        "z",  # dict of sites, each with a leading chain axis
        "potential_energy",  # (C,)
        "accept_prob",  # (C,)
        "mean_accept_prob",  # (C,)
        "diverging",  # (C,)
        "num_steps",
        "adapt_state",
        "rng_key",  # the draw source shared by the batch
    ],
)

_AdamState = namedtuple("_AdamState", ["x", "m", "v", "t"])

_UINT32 = 0xFFFFFFFF


def _halton(i):
    """The van der Corput base-2 sequence at the integer (tensor) ``i``: the
    bits of a ``uint32`` reversed, in ``int64`` masked to 32 bits, then
    converted to float32 as JAX converts the ``uint32``."""
    k = torch.as_tensor(i, dtype=torch.int64) & _UINT32
    k = (((k & 0x55555555) << 1) | ((k >> 1) & 0x55555555)) & _UINT32
    k = (((k & 0x33333333) << 2) | ((k >> 2) & 0x33333333)) & _UINT32
    k = (((k & 0x0F0F0F0F) << 4) | ((k >> 4) & 0x0F0F0F0F)) & _UINT32
    k = (((k & 0x00FF00FF) << 8) | ((k >> 8) & 0x00FF00FF)) & _UINT32
    k = ((k << 16) | (k >> 16)) & _UINT32
    return (k.to(torch.float32) + 0.5) * 2.0**-32


def _adam_ascent(state, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step up the gradient."""
    x, m, v, t = state
    t = t + 1
    m = b1 * m + (1 - b1) * grad
    v = b2 * v + (1 - b2) * grad**2
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    return _AdamState(x + lr * mhat / (torch.sqrt(vhat) + eps), m, v, t)


def _welford_batch_merge(mean, m2, n, batch):
    """Chan et al.'s parallel merge of a ``(C, D)`` batch into running
    moments."""
    c = batch.shape[0]
    bmean = batch.mean(0)
    bm2 = ((batch - bmean) ** 2).sum(0)
    delta = bmean - mean
    tot = n + c
    mean = mean + delta * (c / tot)
    m2 = m2 + bm2 + delta**2 * (n * c / tot)
    return mean, m2, tot


def _select(cond, new, old):
    return tree_map(lambda a, b: torch.where(cond, a, b), new, old)


def _whole_panels(draws, *panels):
    """Every chain's rows of ``(C, ...)`` panels: as they are in one
    process; under a sharded draw source gathered over the chain group, all
    at once and bit for bit (the pad chains left out)."""
    shard = getattr(draws, "shard", None)
    if shard is None:
        return panels
    like = panels[0]
    cols = [p.reshape(p.shape[0], -1).to(like.dtype) for p in panels]
    whole = shard.gather(torch.cat(cols, 1))
    out, at = [], 0
    for p, c in zip(panels, cols):
        out.append(whole[:, at : at + c.shape[1]].reshape((-1,) + tuple(p.shape[1:]))
                   .to(p.dtype))
        at += c.shape[1]
    return out


class CheesHMC(MCMCKernel):
    """Chain-massive adaptive HMC (ChEES).  Needs at least 2 chains run
    together (``chain_method="vectorized"`` or ``"parallel"``): the
    adaptation pools its statistics over the chain batch.

    :param model: model callable (or pass ``potential_fn``).
    :param step_size: initial leapfrog step size.
    :param trajectory_length: initial trajectory length (adapted).
    :param max_num_steps: cap on leapfrog steps per iteration.
    :param target_accept_prob: pooled accept-probability target.
    :param tl_learning_rate: Adam learning rate of the log trajectory length.
    """

    def __init__(self, model=None, potential_fn=None, *, step_size=0.1, trajectory_length=1.0,
                 max_num_steps=1024, target_accept_prob=0.651, tl_learning_rate=0.025,
                 init_strategy=None):
        if not (model is None) ^ (potential_fn is None):
            raise ValueError("Only one of `model` or `potential_fn` must be specified.")
        self._model = model
        self._potential_fn = potential_fn
        self._step_size = step_size
        self._trajectory_length = trajectory_length
        self._max_num_steps = max_num_steps
        self._target_accept_prob = target_accept_prob
        self._tl_lr = tl_learning_rate
        self._init_strategy = init_to_uniform if init_strategy is None else init_strategy
        self._postprocess_fn = None
        self._pe_grad = None
        self._layout = None
        self._num_warmup = None
        self._da_update = dual_averaging()[1]

    def __getstate__(self):
        state = self.__dict__.copy()
        for key in ("_pe_grad", "_postprocess_fn"):
            state[key] = None
        return state

    @property
    def model(self):
        return self._model

    @property
    def sample_field(self):
        return "z"

    @property
    def default_fields(self):
        return ("z", "diverging")

    @property
    def is_ensemble_kernel(self):
        return True

    def get_diagnostics_str(self, state):
        return "{} steps of size {:.2e}. acc. prob={:.2f}".format(
            int(state.num_steps), float(state.adapt_state.step_size),
            float(state.mean_accept_prob.mean()),
        )

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        """``rng_key``: a ``torch.Generator`` on the chains' device (or a draw
        source); ``num_chains`` must be 2 or more."""
        if num_chains is None or num_chains < 2:
            raise ValueError(
                "CheesHMC pools statistics across chains: run it with "
                'num_chains >= 2 and chain_method="vectorized".'
            )
        model_kwargs = {} if model_kwargs is None else model_kwargs
        infer_util.pin_full_f32_matmul()
        draws = core.as_draws(rng_key)
        if self._model is not None:
            info = initialize_model(
                getattr(draws, "generator", rng_key), self._model, num_chains=num_chains,
                dynamic_args=True, init_strategy=self._init_strategy, model_args=model_args,
                model_kwargs=model_kwargs,
            )
            self._postprocess_fn = info.postprocess_fn
            if init_params is None:
                init_params = info.param_info.z
            potential_fn = info.potential_fn(*model_args, **model_kwargs)
        else:
            if init_params is None:
                raise ValueError("`init_params` must be provided with `potential_fn`.")
            if isinstance(init_params, ParamInfo):
                init_params = init_params.z
            potential_fn = self._potential_fn

        layout = FlatLayout(tree_map(lambda x: x[0], init_params))
        self._layout = layout
        self._pe_grad = core.batched_potential(potential_fn, layout)
        self._num_warmup = num_warmup
        z_flat = layout.ravel_batch(init_params)
        pe = infer_util.batched_value(lambda flat: potential_fn(layout.unravel_one(flat)))(z_flat)

        def scalar(value, dtype=z_flat.dtype):
            return torch.tensor(value, dtype=dtype, device=z_flat.device)

        d = z_flat.shape[1]
        step_size = scalar(self._step_size)
        zero = scalar(0.0)
        adapt = CheesAdaptState(
            step_size=step_size,
            inverse_mass_matrix=z_flat.new_ones(d),
            trajectory_length=scalar(self._trajectory_length),
            da_state=dual_averaging()[0](torch.log(10 * step_size)),
            tl_state=_AdamState(torch.log(scalar(self._trajectory_length)), zero, zero,
                                scalar(0, torch.int64)),
            wf_mean=z_flat.new_zeros(d),
            wf_m2=z_flat.new_zeros(d),
            wf_n=zero,
        )
        return CheesHMCState(
            i=0,
            z=init_params,
            potential_energy=pe,
            accept_prob=z_flat.new_zeros(num_chains),
            mean_accept_prob=z_flat.new_zeros(num_chains),
            diverging=torch.zeros(num_chains, dtype=torch.bool, device=z_flat.device),
            num_steps=scalar(0, torch.int64),
            adapt_state=adapt,
            rng_key=rng_key,
        )

    def postprocess_fn(self, args, kwargs):
        if self._postprocess_fn is None:
            return identity
        return self._postprocess_fn(*args, **kwargs)

    def sample(self, state, model_args=(), model_kwargs=None):
        a = state.adapt_state
        draws = core.as_draws(state.rng_key)
        zf = self._layout.ravel_batch(state.z)
        C, D = zf.shape
        eps = a.step_size
        inv_mass = a.inverse_mass_matrix
        # the jitter of step i, a float32 number made on the host
        u = float(_halton(state.i))
        traj = a.trajectory_length
        traj = torch.where(torch.isnan(traj), eps, torch.nan_to_num(traj))
        num_steps = torch.clamp(torch.ceil(u * traj / eps), 1, self._max_num_steps).to(
            torch.int64)

        p0 = draws.normals((C, D), zf) / torch.sqrt(inv_mass)
        _, g = self._pe_grad(zf)
        z, p = zf, p0
        for _ in range(int(num_steps)):  # the one host read of the transition
            p_half = p - 0.5 * eps * g
            z = z + eps * p_half * inv_mass
            pe_prop, g = self._pe_grad(z)
            p = p_half - 0.5 * eps * g
        z_prop, p_prop = z, p
        pe0 = state.potential_energy

        ke0 = 0.5 * (p0**2 * inv_mass).sum(-1)
        ke1 = 0.5 * (p_prop**2 * inv_mass).sum(-1)
        delta = (pe_prop + ke1) - (pe0 + ke0)
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        diverging = delta > 1000.0
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
        accept = draws.uniforms((C,), zf) < accept_prob
        z_new = torch.where(accept[:, None], z_prop, zf)
        pe_new = torch.where(accept, pe_prop, pe0)

        i = state.i + 1
        in_warmup = i <= self._num_warmup
        if in_warmup:
            adapt = self._adapt(a, i, u, *_whole_panels(
                draws, zf, z_prop, p_prop, z_new, accept_prob, diverging))
        else:
            adapt = a
        n = i if in_warmup else i - self._num_warmup
        mean_accept = state.mean_accept_prob + (accept_prob - state.mean_accept_prob) / max(n, 1)
        return CheesHMCState(
            i=i,
            z=self._layout.unravel_batch(z_new),
            potential_energy=pe_new,
            accept_prob=accept_prob,
            mean_accept_prob=mean_accept,
            diverging=diverging,
            num_steps=num_steps,
            adapt_state=adapt,
            rng_key=state.rng_key,
        )

    def _adapt(self, a, i, u, zf, z_prop, p_prop, z_new, accept_prob, diverging):
        """The pooled warmup adaptation after transition ``i``."""
        C = zf.shape[0]
        eps = a.step_size
        # the ChEES gradient in mass-whitened coordinates, so that the
        # criterion and the trajectory length are free of the scales
        scale = torch.sqrt(a.inverse_mass_matrix)
        zw, zpw = zf / scale, z_prop / scale
        zwc = zw - zw.mean(0)
        zpwc = zpw - zpw.mean(0)
        crit = (zpwc**2).sum(-1) - (zwc**2).sum(-1)
        g_i = crit * (zpwc * (p_prop * scale)).sum(-1) * u
        # non-finite proposals carry no signal (0 * nan would poison Adam)
        good = torch.isfinite(g_i) & ~diverging
        w = torch.where(good, accept_prob, 0.0)
        wg = torch.where(good, w * g_i, 0.0)
        chees_grad = wg.sum() / (w.sum() + 1e-6)
        chees_grad = chees_grad / torch.sqrt((wg**2).mean() + 1e-12)

        # adapt only while the pooled accept carries signal
        tl_adapt = w.sum() > 0.05 * C
        tl_state = _adam_ascent(a.tl_state, chees_grad, self._tl_lr)
        log_tl = torch.clamp(tl_state.x, torch.log(eps), torch.log(eps * self._max_num_steps))
        tl_state = _select(tl_adapt, tl_state._replace(x=log_tl), a.tl_state)
        new_tl = torch.where(tl_adapt, torch.exp(tl_state.x), a.trajectory_length)

        da_state = self._da_update(self._target_accept_prob - accept_prob.mean(), a.da_state)
        # frozen at the averaged iterate at the end of warmup
        new_eps = torch.exp(da_state.x_t if i < self._num_warmup else da_state.x_avg)

        # mass: Welford over the chain batch, after a buffer of a tenth
        wf_mean, wf_m2, wf_n = a.wf_mean, a.wf_m2, a.wf_n
        new_inv_mass = a.inverse_mass_matrix
        if i > self._num_warmup // 10:
            wf_mean, wf_m2, wf_n = _welford_batch_merge(wf_mean, wf_m2, wf_n, z_new)
            var = wf_m2 / torch.clamp(wf_n - 1, min=1)
            shrink = wf_n / (wf_n + 5.0)
            est_inv_mass = shrink * var + 1e-3 * (1 - shrink)
            new_inv_mass = torch.where(wf_n > 2 * C, est_inv_mass, new_inv_mass)
        return CheesAdaptState(new_eps, new_inv_mass, new_tl, da_state, tl_state, wf_mean,
                               wf_m2, wf_n)


def chees_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``CheesHMCState`` from a JAX one whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, state)``).  JAX's key is dropped:
    ``rng_key`` is the generator or draw source the port's state carries."""
    get = partial(infer_util.state_field, fields)
    to = partial(infer_util.tree_from_numpy, device=device)
    adapt = get("adapt_state")
    field = partial(infer_util.state_field, adapt)
    return CheesHMCState(
        int(get("i")), to(get("z")), to(get("potential_energy")), to(get("accept_prob")),
        to(get("mean_accept_prob")), to(get("diverging")), to(get("num_steps")),
        CheesAdaptState(
            to(field("step_size")), to(field("inverse_mass_matrix")),
            to(field("trajectory_length")), DualAveragingState(*to(tuple(field("da_state")))),
            _AdamState(*to(tuple(field("tl_state")))), to(field("wf_mean")), to(field("wf_m2")),
            to(field("wf_n")),
        ),
        rng_key,
    )

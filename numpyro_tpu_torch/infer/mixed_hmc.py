"""MixedHMC: HMC over the continuous sites with clock-driven Metropolis
updates of the discrete sites inside the trajectory (port of
``numpyro_tpu/infer/mixed_hmc.py``; Zhou 2020, "Mixed Hamiltonian Monte Carlo
for Mixed Discrete and Continuous Variables").

Every chain carries its own event clock, discrete kinetic budgets and
segment lengths.  The composite trajectory alternates leapfrog segments
(``hmc_core.integrate_segment``, the momentum carried across segments) with
one discrete flip per chain, for all chains at once.  Each segment runs as
many leapfrogs as its longest chain needs (one host read of the count).

A transition takes its draws from the state's draw source in this order:
``exponentials((C, n))`` (the discrete kinetic budgets), ``uniforms((C,
n))`` (the arrival times), ``normals((C, D))`` (the momentum), then per
discrete update the element proposal's draw (``gumbels((C, smax))`` in the
conditional modes, ``randints`` in the random-walk ones), and last
``uniforms((C,))`` (the accept test).
"""

from __future__ import annotations

from collections import namedtuple

import torch

from numpyro_tpu_torch.infer import hmc_core as core
from numpyro_tpu_torch.infer import util as infer_util
from numpyro_tpu_torch.infer.hmc_gibbs import (
    DiscreteHMCGibbs,
    _batched,
    _element_proposal,
    _site_element_layout,
    _unbatched,
    gibbs_state_from_numpy,
)

__all__ = ["MixedHMC", "MixedHMCState", "mixed_state_from_numpy"]

MixedHMCState = namedtuple("MixedHMCState", "z, hmc_state, rng_key, accept_prob")


class MixedHMC(DiscreteHMCGibbs):
    """Needs an ``HMC`` inner kernel with a fixed trajectory length (the
    event-clock scheme does not go with NUTS's termination).

    :param num_discrete_updates: discrete updates per trajectory (default:
        the number of discrete elements)."""

    def __init__(self, inner_kernel, *, num_discrete_updates=None, random_walk=False,
                 modified=False):
        super().__init__(inner_kernel, random_walk=random_walk, modified=modified)
        if inner_kernel._algo == "NUTS":
            raise ValueError("The algorithm only works with HMC and does not support NUTS.")
        self._num_discrete_updates = num_discrete_updates
        self._wa_update = None
        self._layout = None

    def init(self, rng_key, num_warmup, init_params=None, model_args=(), model_kwargs=None,
             num_chains=None):
        state = super().init(rng_key, num_warmup, init_params, model_args, model_kwargs,
                             num_chains=num_chains)
        _, sizes = _site_element_layout(self._support_sizes)
        if self._num_discrete_updates is None:
            self._num_discrete_updates = int(sizes.shape[0])
        self._num_warmup = num_warmup
        # the composite step owns its adaptation: the composite accept
        # statistic drives the dual averaging, with no step-size search
        inner = self.inner_kernel
        blocks = self._ensure_layout(state.hmc_state.z, num_chains is not None)
        _, self._wa_update = core.build_warmup(
            None, blocks, num_warmup, adapt_step_size=inner._adapt_step_size,
            adapt_mass_matrix=inner._adapt_mass_matrix,
            target_accept_prob=inner._target_accept_prob, find_step_size=False,
        )
        zero = torch.zeros_like(state.hmc_state.accept_prob)
        return MixedHMCState(state.z, state.hmc_state, state.rng_key, zero)

    def _ensure_layout(self, z_hmc_tree, batched):
        if self._layout is None:
            proto = {k: v[0] for k, v in z_hmc_tree.items()} if batched else z_hmc_tree
            self._layout = core.FlatLayout(proto)
            self._block_struct = core.build_mass_blocks(self._layout, self.inner_kernel._dense_mass)
        return self._block_struct

    def sample(self, state, model_args, model_kwargs):
        model_kwargs = {} if model_kwargs is None else model_kwargs
        if not self._chain_mode:
            state = _batched(state)
        state = self._sample_batched(state, model_args, model_kwargs)
        return state if self._chain_mode else _unbatched(state)

    def _sample_batched(self, state, model_args, model_kwargs):
        blocks = self._ensure_layout(state.hmc_state.z, True)
        layout, glayout = self._layout, self._gibbs_layout
        hs = state.hmc_state
        adapt = hs.adapt_state
        _, sizes_np = _site_element_layout(self._support_sizes)
        nd = sizes_np.shape[0]
        smax = int(sizes_np.max())
        num_updates = self._num_discrete_updates
        draws = core.as_draws(state.rng_key)
        z_flat = layout.ravel_batch(hs.z)
        c, d = z_flat.shape
        device = z_flat.device
        sizes = torch.as_tensor(sizes_np, dtype=torch.int64, device=device)
        rows = torch.arange(c, device=device)
        disc0 = glayout.ravel_batch({k: v for k, v in state.z.items() if k not in hs.z})
        disc = disc0
        chain_pe = self._chain_potential(model_args, model_kwargs)

        def pe_grad_given(disc_panel):
            return core.batched_potential(
                lambda g: lambda zc: chain_pe(g, zc), layout,
                per_chain=glayout.unravel_batch(disc_panel),
                forward_mode=self.inner_kernel._forward_mode_differentiation,
            )

        ke = draws.exponentials((c, nd), z_flat)
        arrival = draws.uniforms((c, nd), z_flat)
        eps = draws.normals((c, d), z_flat)
        # the event-clock time spanned by num_updates arrivals
        whole_rounds = (num_updates - 1) // nd
        frac_idx = (num_updates - 1) % nd
        total_time = whole_rounds + torch.sort(arrival, dim=1).values[:, frac_idx]
        time_unit = self.inner_kernel._trajectory_length / total_time  # (C,)

        pe0, grad0 = hs.potential_energy, layout.ravel_batch(hs.z_grad)
        inv = adapt.inverse_mass_matrix
        r = core.draw_momentum(blocks, adapt.mass_matrix_sqrt, eps)
        energy_old = pe0 + core.kinetic(blocks, inv, r)
        z, pe, grad = z_flat, pe0, grad0
        dpe = torch.zeros_like(pe0)
        n_leap = torch.zeros((c,), dtype=torch.int32, device=device)
        for _ in range(num_updates):
            idx = torch.argmin(arrival, dim=1)  # (C,)
            wait = arrival[rows, idx]
            hit = torch.arange(nd, device=device)[None, :] == idx[:, None]
            arrival = torch.where(hit, 1.0, arrival - wait[:, None])
            steps = torch.ceil(wait * time_unit / adapt.step_size).to(torch.int32)
            z, r, pe, grad = core.integrate_segment(
                pe_grad_given(disc), blocks, inv, adapt.step_size, steps, z, r, pe, grad,
            )
            n_leap = n_leap + steps
            # one discrete flip per chain, paid from its kinetic budget
            z_hmc = layout.unravel_batch(z)
            pe_cand, pe_one = self._candidate_potentials(model_args, model_kwargs, z_hmc)
            disc_prop, _, log_ratio = _element_proposal(
                pe_cand, pe_one, draws, disc, pe, idx, sizes[idx], smax, self._mode
            )
            budget = ke[rows, idx] + log_ratio
            take = budget > 0
            disc = torch.where(take[:, None], disc_prop, disc)
            ke = torch.where(hit & take[:, None], budget[:, None], ke)
            pe_new, grad = pe_grad_given(disc)(z)
            dpe = dpe + pe_new - pe
            pe = pe_new

        energy_new = pe + core.kinetic(blocks, inv, r)
        delta = energy_new - energy_old - dpe
        delta = torch.where(torch.isnan(delta), torch.inf, delta)
        accept_prob = torch.exp(torch.clamp(-delta, max=0.0))
        take = torch.log(draws.uniforms((c,), z_flat)) < -delta
        z_flat = core._sel(take, z, z_flat)
        pe = torch.where(take, pe, pe0)
        grad = core._sel(take, grad, grad0)
        disc = core._sel(take, disc, disc0)

        i = int(hs.i)
        if i < self._num_warmup:
            adapt = self._wa_update(i, adapt, accept_prob, z_flat, pe, grad, draws)
        n = i + 1 if i < self._num_warmup else i + 1 - self._num_warmup
        mean_accept = hs.mean_accept_prob + (accept_prob - hs.mean_accept_prob) / n
        hmc_state = hs._replace(
            i=i + 1,
            z=layout.unravel_batch(z_flat),
            z_grad=layout.unravel_batch(grad),
            potential_energy=pe,
            energy=torch.where(take, energy_new, energy_old),
            num_steps=n_leap,
            accept_prob=accept_prob,
            mean_accept_prob=mean_accept,
            adapt_state=adapt,
        )
        z = {**glayout.unravel_batch(disc), **hmc_state.z}
        return MixedHMCState(z, hmc_state, state.rng_key, accept_prob)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_wa_update"] = None
        state["_prototype_trace"] = None
        state["_layout"] = None
        return state


def mixed_state_from_numpy(fields, device="cpu", rng_key=None):
    """The port's ``MixedHMCState`` from a JAX one whose leaves are numpy
    arrays; JAX's keys are dropped for ``rng_key``."""
    base = gibbs_state_from_numpy(fields, device, rng_key)
    return MixedHMCState(base.z, base.hmc_state, rng_key,
                         infer_util.tree_from_numpy(infer_util.state_field(fields, "accept_prob"),
                                                    device))

"""``examples/annotation.py``'s Dawid-Skene model in the port
(``chip_smoke.dawid_skene``) against the JAX package's own example, on the
example's data (60 items, 5 annotators, 3 classes, numpy's RandomState(0)):
the potential and its gradient with the class ``c`` enumerated through
``Vindex(beta)[positions, c, :]`` at the same 8 unconstrained points (rtol
1e-5, atol 1e-5 of the largest gradient entry), and phase 18b's DSL model
against the JAX package at the same points."""

import os
import sys
from functools import partial

import numpy as np
import torch

import jax
import jax.numpy as jnp

import numpyro_tpu as jnpt
import numpyro_tpu.contrib.enum as jenum
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.control_flow import cond as jcond
from numpyro_tpu.infer import util as jutil
from numpyro_tpu_torch.infer import util

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from examples.annotation import dawid_skene  # noqa: E402

torch.set_num_threads(1)

C = 8
RTOL = 1e-5


def _same_potential(info, jmodel, jargs, z, enum, jit=True):
    jvg = jax.vmap(jax.value_and_grad(
        lambda p: jutil.potential_energy(jmodel, jargs, {}, p, enum=enum)))
    jvg = jax.jit(jvg) if jit else jvg
    jpe, jg = jvg({k: jnp.asarray(v) for k, v in z.items()})
    tpe, tg = util.batched_value_and_grad(info.potential_fn)(
        {k: torch.from_numpy(v) for k, v in z.items()})
    np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=RTOL)
    assert set(tg) == set(jg) == set(z)
    for k in jg:
        g = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), g, rtol=RTOL, atol=RTOL * np.abs(g).max(),
                                   err_msg=k)


def test_annotation_data_is_the_example_s():
    true_c, annotations = cs.annotation_data()
    assert annotations.shape == (cs.ANNOT_N, cs.ANNOT_J) and true_c.shape == (cs.ANNOT_N,)
    assert set(np.unique(annotations)) <= set(range(cs.ANNOT_K))
    # 0.75 + 0.25 / 3 of the labels name the true class
    agree = (annotations == true_c[:, None]).mean()
    assert abs(agree - (0.75 + 0.25 / 3)) < 0.06


def test_dawid_skene_potential_matches_jax():
    _, annotations = cs.annotation_data()
    info = util.initialize_model(torch.Generator().manual_seed(0), cs.annotation_model,
                                 num_chains=C, model_args=(torch.from_numpy(annotations),))
    assert {k: tuple(v.shape[1:]) for k, v in info.param_info.z.items()} == {
        "pi": (cs.ANNOT_K - 1,), "beta": (cs.ANNOT_J, cs.ANNOT_K, cs.ANNOT_K - 1)}
    rng = np.random.default_rng(0)
    z = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in info.param_info.z.items()}
    jmodel = jenum.enum(jenum.config_enumerate(partial(
        dawid_skene, num_classes=cs.ANNOT_K, num_annotators=cs.ANNOT_J)), first_available_dim=-3)
    jargs = (jnp.arange(cs.ANNOT_J), jnp.asarray(annotations))
    _same_potential(info, jmodel, jargs, z, enum=True)


def _dsl_model_jax(y):
    """``chip_smoke.dsl_model`` in the JAX package."""
    full = partial(jnp.full, (), dtype=jnp.float32)
    mask = ~jnp.isnan(y)
    obs = jnp.where(mask, y, 0.0)
    with jhandlers.scope(prefix="dsl"):
        mu = jnpt.sample("mu", jdist.Normal(full(0.0), full(2.0)).expand([y.shape[0]])
                         .to_event(1))
        sigma = jnpt.sample("sigma", jdist.HalfNormal(full(1.0)))
        with jhandlers.collapse():
            theta = jnpt.sample("theta", jdist.Normal(full(0.5), full(2.0)))
            jnpt.sample("anchor", jdist.Normal(theta, sigma), obs=full(1.3))
    u = jnpt.sample("u", jdist.Normal(full(0.0), full(1.0)))
    shift = jcond(u > 0, lambda s: jnpt.sample("shift", jdist.Normal(s, full(1.0))),
                  lambda s: jnpt.sample("shift", jdist.Normal(-s, full(2.0))), full(1.0))
    with jhandlers.scope(prefix="dsl"), jhandlers.scale(scale=0.5), \
            jnpt.plate_stack("grid", tuple(y.shape)):
        jnpt.sample("y", jdist.Normal(mu[:, None] + shift, sigma), obs=obs, obs_mask=mask)


def test_dsl_model_and_its_twin_match_jax():
    """Phase 18b's model (``obs_mask``, ``collapse`` with a latent scale,
    ``cond`` on a latent predicate, ``scale``, ``scope``, ``plate_stack``)
    and its twin without those handlers, against the JAX package's model,
    which runs without ``jit``: the JAX package's ``scale`` raises under
    ``jit`` (``tests/test_torch_handlers_tail.py``)."""
    y = cs.dsl_data()
    assert np.isnan(y).sum() == cs.DSL_MISSING
    rng = np.random.default_rng(1)
    z = None
    for model in (cs.dsl_model, cs.dsl_twin):
        info = util.initialize_model(torch.Generator().manual_seed(0), model, num_chains=C,
                                     model_args=(torch.from_numpy(y),))
        if z is None:
            z = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in info.param_info.z.items()}
            assert (z["u"] > 0).any() and (z["u"] <= 0).any()
        _same_potential(info, _dsl_model_jax, (jnp.asarray(y),), z, enum=False, jit=False)

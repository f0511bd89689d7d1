"""The JAX package's own runs of ``chip_smoke.py`` phase 14's legs, on the
CPU, as the reference for ``chip_smoke.IAF_GATE`` and ``DAIS_GATE``.

    JAX_PLATFORMS=cpu python3 -m dev.flows_reference [legs] [keys]

Run from the root of the repo.  ``legs`` is a comma-separated subset of
``iaf,dais,dais_spread,moon`` (``iaf,dais,moon`` by default; ``dais_spread:8`` runs the
spread at 8 particles alone), ``keys`` the PRNG keys (0 1 2 by default).

- ``iaf``: ``AutoIAFNormal`` (3 flows, hidden widths [55, 55], ELU) with
  ``Trace_ELBO`` and ``Adam(0.01)`` at ``chip_smoke.IAF_RUN`` on the covtype-shape data of
  ``chip_smoke.make_data`` (581,012 x 55, numpy seed 0) in split mode;
  e = max |mean of ``IAF_DRAWS`` draws of ``sample_posterior`` - generating
  coefficient|, and the gate max(2e, e + 0.05) for the largest e.  The JAX
  package's packed guides leave ``log q`` out (ROADMAP.md, Queue 3), so its
  flow is fitted without an entropy term and heads towards the MAP (at 300
  steps its draws' std is still 0.008-0.009, the port's 0.009).
- ``dais``: ``examples/dais_demo.py``'s ``AutoDAIS(K=4, eta_init=0.01)`` and
  ``AutoDiagonalNormal`` at ``chip_smoke.DAIS_DEMO``, both started at w = 0
  (``init_to_value``, so that the keys differ only in their noise): the
  posterior mean and sd per coordinate and the correlation of the draws for
  each key.  The reference is AutoDAIS's key 0; e is the largest gap of its
  other keys to it, in the mean and sd and, apart, in the correlation; each
  gate is max(2e, e + 0.05).  The mean-field rows show what a guide that
  misses the correlation reads against those gates.
- ``dais_spread``: ``AutoDAIS`` alone as in ``dais``, at 8 and at 16
  particles, for each key: the share of runs whose correlation stays above
  -0.3 (the annealing's step size kept clipped near 0, a mean-field fit);
  ``python3 -m dev.dais_spread`` gives the port's.
- ``moon``: ``examples/neutra.py`` at ``chip_smoke.DUAL_MOON``'s lengths with
  ``chip_smoke``'s chains: the share of NUTS draws with x0 > 0.
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import D, DAIS_DEMO, DUAL_MOON, IAF_DRAWS, IAF_RUN  # noqa: E402
from dev.chees_reference import make_data, model as glm_model  # noqa: E402
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as dist  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS, SVI, Trace_ELBO  # noqa: E402
from numpyro_tpu.infer.autoguide import (  # noqa: E402
    AutoBNAFNormal, AutoDAIS, AutoDiagonalNormal, AutoIAFNormal,
)
from numpyro_tpu.infer.initialization import init_to_value  # noqa: E402
from numpyro_tpu.infer.reparam import NeuTraReparam  # noqa: E402
from numpyro_tpu.ops.glm import prepare_glm_data  # noqa: E402
from numpyro_tpu.optim import Adam  # noqa: E402


def gate(errs):
    e = max(errs)
    return e, max(2 * e, e + 0.05)


def iaf(keys):
    X, y, true_w = make_data(581_012)
    data = prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype="split")
    particles, steps = IAF_RUN
    errs = []
    for key in keys:
        guide = AutoIAFNormal(glm_model, num_flows=3, hidden_dims=[D, D])
        svi = SVI(glm_model, guide, Adam(0.01), Trace_ELBO(num_particles=particles))
        t0 = time.perf_counter()
        res = svi.run(random.PRNGKey(key), steps, data, progress_bar=False)
        w = np.asarray(guide.sample_posterior(random.PRNGKey(key + 100), res.params,
                                              sample_shape=(IAF_DRAWS,))["w"])
        err = float(np.abs(w.mean(0) - true_w).max())
        errs.append(err)
        losses = np.asarray(res.losses)
        print(f"iaf key {key}: {time.perf_counter() - t0:.1f} s; loss {losses[:50].mean():.2f} "
              f"-> {losses[-50:].mean():.2f}; draws' std median {np.median(w.std(0)):.5f}; "
              f"e = {err:.4f}", flush=True)
    e, g = gate(errs)
    print(f"iaf: largest e {e:.4f}, gate max(2e, e + 0.05) = {g:.4f}", flush=True)


def dais_model(X, y):
    w = numpyro_tpu.sample("w", dist.Normal(jnp.zeros(X.shape[1]), 1.0).to_event(1))
    with numpyro_tpu.plate("N", X.shape[0]):
        numpyro_tpu.sample("y", dist.Bernoulli(logits=X @ w), obs=y)


def dais_demo_xy(n):
    """``examples/dais_demo.py``'s strongly correlated design, numpy seed 0."""
    rng = np.random.RandomState(0)
    base = rng.randn(n, 1)
    X = np.concatenate([base + 0.1 * rng.randn(n, 1), base + 0.1 * rng.randn(n, 1)], 1)
    y = (rng.rand(n) < 0.5).astype(np.float32)
    return jnp.asarray(X, jnp.float32), jnp.asarray(y)


def dais(keys):
    n, steps, lr, particles, draws = DAIS_DEMO
    X, y = dais_demo_xy(n)
    readings = {}
    for name, make in (("AutoDAIS", lambda init: AutoDAIS(dais_model, K=4, eta_init=0.01,
                                                           init_loc_fn=init)),
                       ("mean-field", lambda init: AutoDiagonalNormal(dais_model,
                                                                      init_loc_fn=init))):
        for key in keys:
            guide = make(init_to_value(values={"w": jnp.zeros(2)}))
            res = SVI(dais_model, guide, Adam(lr), Trace_ELBO(num_particles=particles)).run(
                random.PRNGKey(key), steps, X, y, progress_bar=False)
            w = np.asarray(guide.sample_posterior(random.PRNGKey(key + 100), res.params,
                                                  sample_shape=(draws,))["w"], np.float64)
            reading = (w.mean(0), w.std(0, ddof=1), float(np.corrcoef(w.T)[0, 1]))
            readings.setdefault(name, []).append(reading)
            print(f"dais {name} key {key}: final loss "
                  f"{float(np.asarray(res.losses)[-20:].mean()):.2f}; mean "
                  f"{np.round(reading[0], 4).tolist()}, sd {np.round(reading[1], 4).tolist()}, "
                  f"correlation {reading[2]:.4f}", flush=True)
    mean0, sd0, corr0 = readings["AutoDAIS"][0]

    def gaps(reading):
        m, s, c = reading
        return max(np.abs(m - mean0).max(), np.abs(s - sd0).max()), abs(c - corr0)

    e_ms, g_ms = gate([gaps(r)[0] for r in readings["AutoDAIS"][1:]] or [0.0])
    e_c, g_c = gate([gaps(r)[1] for r in readings["AutoDAIS"][1:]] or [0.0])
    print(f"dais: reference (AutoDAIS, key {keys[0]}) mean {np.round(mean0, 4).tolist()}, sd "
          f"{np.round(sd0, 4).tolist()}, correlation {corr0:.4f}; largest gap of the other keys "
          f"in the mean and sd e {e_ms:.4f}, gate {g_ms:.4f}; in the correlation e {e_c:.4f}, "
          f"gate {g_c:.4f}", flush=True)
    for key, reading in zip(keys, readings["mean-field"]):
        ms, c = gaps(reading)
        print(f"dais: mean-field key {key} against the reference: mean and sd {ms:.4f}, "
              f"correlation {c:.4f}", flush=True)


def dais_spread(keys, particles_list=(8, 16)):
    n, steps, lr, _, draws = DAIS_DEMO
    X, y = dais_demo_xy(n)
    for particles in particles_list:
        idle = []
        for key in keys:
            guide = AutoDAIS(dais_model, K=4, eta_init=0.01,
                             init_loc_fn=init_to_value(values={"w": jnp.zeros(2)}))
            res = SVI(dais_model, guide, Adam(lr), Trace_ELBO(num_particles=particles)).run(
                random.PRNGKey(key), steps, X, y, progress_bar=False)
            w = np.asarray(guide.sample_posterior(random.PRNGKey(key + 100), res.params,
                                                  sample_shape=(draws,))["w"], np.float64)
            corr = float(np.corrcoef(w.T)[0, 1])
            if corr > -0.3:
                idle.append(key)
            jax.clear_caches()  # each guide compiles anew; free what it compiled
            print(f"dais_spread {particles} particles key {key}: correlation {corr:.3f}, "
                  f"eta_coeff {float(res.params['auto_eta_coeff']):.4f}", flush=True)
        print(f"dais_spread (JAX package): {particles} particles, keys {keys[0]}-{keys[-1]}: "
              f"{len(idle)} of {len(keys)} runs idle (correlation > -0.3): {idle}", flush=True)


def dual_moon_pe(x):
    term1 = 0.5 * ((jnp.linalg.norm(x, axis=-1) - 2) / 0.4) ** 2
    term2 = -0.5 * ((x[..., :1] + jnp.array([-2.0, 2.0])) / 0.6) ** 2
    return term1 - jnp.log(jnp.exp(term2).sum(-1))


def moon_model():
    x = numpyro_tpu.sample("x", dist.Normal(jnp.zeros(2), 10.0).to_event(1))
    numpyro_tpu.factor("dual_moon", -dual_moon_pe(x))


def moon(keys):
    steps, lr, chains, warmup, samples, depth = DUAL_MOON[:6]
    for key in keys:
        guide = AutoBNAFNormal(moon_model, hidden_factors=[8, 8])
        res = SVI(moon_model, guide, Adam(lr), Trace_ELBO()).run(
            random.PRNGKey(key), steps, progress_bar=False)
        neutra = NeuTraReparam(guide, res.params)
        mcmc = MCMC(NUTS(neutra.reparam(moon_model), max_tree_depth=depth[1]),
                    num_warmup=warmup, num_samples=samples, num_chains=chains,
                    chain_method="vectorized", progress_bar=False)
        mcmc.run(random.PRNGKey(key + 100))
        x = np.asarray(neutra.transform_sample(mcmc.get_samples()["x_shared_latent"])["x"])
        ring = float((np.abs(np.linalg.norm(x, axis=-1) - 2) < 3 * 0.4).mean())
        losses = np.asarray(res.losses)
        print(f"moon key {key}: loss {losses[:20].mean():.2f} -> {losses[-20:].mean():.2f}; "
              f"share of draws with x0 > 0 {float((x[:, 0] > 0).mean()):.3f}; on the ring "
              f"{ring:.3f}", flush=True)


def main(argv):
    legs = argv[0].split(",") if argv else ["iaf", "dais", "moon"]
    keys = [int(a) for a in argv[1:]] or [0, 1, 2]
    for leg in legs:
        # "dais_spread:8" runs the spread at 8 particles alone
        leg, _, particles = leg.partition(":")
        if particles:
            dais_spread(keys, (int(particles),))
            continue
        {"iaf": iaf, "dais": dais, "dais_spread": dais_spread, "moon": moon}[leg](keys)


if __name__ == "__main__":
    main(sys.argv[1:])

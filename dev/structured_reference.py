"""The JAX package's own runs of phase 17a's LKJ covariance model and 17b's
ordered Gaussian mixture, on the CPU, as the references for the port's
(``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.structured_reference lkj|mix [chains warmup samples \
        warmup_depth sample_depth [keys...]]

Run from the root of the repo.  Samples the model on phase 17's data
(``chip_smoke.lkj_data`` and ``mix_data``, numpy draws from seed 0) with
``NUTS(max_tree_depth=(warmup_depth, sample_depth))`` and vectorized chains
(by default phase 17's configuration) for each key (0 to 4 by default).  ``lkj`` prints, per key, the largest
|posterior mean - generating correlation| over the 10 correlations; ``mix``
the posterior means of the ordered locations and their largest error.  Then
the first key's error e_J, the largest gap of another key's error to it, and
the gate max(2 e_J, e_J + 0.05) of phase 17.
"""

import os
import sys
import time

import numpy as np

import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import numpyro_tpu  # noqa: E402
import numpyro_tpu.distributions as dist  # noqa: E402
from numpyro_tpu.distributions.transforms import OrderedTransform  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS  # noqa: E402

# phase 17's data, from the numpy draws chip_smoke.py makes
LKJ_CORR = np.array(cs.LKJ_CORR)
# 17a's configuration, and the mixture's NUTS run that phase 17 dropped
# (PERF.md §6)
RUNS = {"lkj": cs.LKJ_RUN, "mix": (32, 10, 5, (3, 3))}


def lkj_model(y, observed=True):
    d = y.shape[-1]
    L = numpyro_tpu.sample("L", dist.LKJCholesky(d, cs.LKJ_ETA))
    sigma = numpyro_tpu.sample("sigma", dist.HalfNormal(jnp.full(d, 2.5)).to_event(1))
    mu = numpyro_tpu.sample("mu", dist.Normal(jnp.zeros(d), 5.0).to_event(1))
    with numpyro_tpu.plate("obs", y.shape[0]):
        numpyro_tpu.sample("y", dist.MultivariateNormal(mu, scale_tril=sigma[..., None] * L),
                           obs=y if observed else None)


def mix_model(y, observed=True):
    mu = numpyro_tpu.sample("mu", dist.TransformedDistribution(dist.Normal(jnp.zeros(3), 5.0),
                                                               OrderedTransform()))
    w = numpyro_tpu.sample("w", dist.Dirichlet(jnp.ones(3)))
    s = numpyro_tpu.sample("s", dist.HalfNormal(1.0))
    with numpyro_tpu.plate("obs", y.shape[0]):
        numpyro_tpu.sample("y", dist.MixtureSameFamily(dist.Categorical(w), dist.Normal(mu, s)),
                           obs=y if observed else None)


def one_run(which, key, chains, warmup, samples, depths):
    model, y = (lkj_model, cs.lkj_data()) if which == "lkj" else (mix_model, cs.mix_data())
    mcmc = MCMC(NUTS(model, max_tree_depth=depths), num_warmup=warmup, num_samples=samples,
                num_chains=chains, chain_method="vectorized", progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(key), jnp.asarray(y))
    draws = mcmc.get_samples()
    if which == "lkj":
        L = np.asarray(draws["L"], np.float64)
        corr = (L @ np.swapaxes(L, -1, -2)).mean(0)
        rows, cols = np.tril_indices(5, -1)
        e = float(np.abs(corr - LKJ_CORR)[rows, cols].max())
        label = f"largest correlation error {e:.4f}"
    else:
        means = np.asarray(draws["mu"], np.float64).mean(0)
        e = float(np.abs(means - np.array(cs.MIX_LOCS)).max())
        label = f"mu means {np.round(means, 4).tolist()}, largest error {e:.4f}"
    print(f"key {key}: {time.perf_counter() - t0:.1f} s, {label}", flush=True)
    return e


def main(argv):
    which = argv[0] if argv else "lkj"
    numbers = [int(a) for a in argv[1:]]
    chains, warmup, samples, dw, ds = numbers[:5] if len(numbers) >= 5 else (
        RUNS[which][:3] + RUNS[which][3])
    keys = numbers[5:] or [0, 1, 2, 3, 4]
    errors = [one_run(which, k, chains, warmup, samples, (dw, ds)) for k in keys]
    ref = errors[0]
    spread = max(abs(e - ref) for e in errors[1:]) if len(errors) > 1 else float("nan")
    print(f"{which}: {chains} chains, {warmup} + {samples}, depths ({dw}, {ds}): key {keys[0]} "
          f"e_J = {ref:.4f}, the others within {spread:.4f} of it, gate "
          f"max(2 e_J, e_J + 0.05) = {max(2 * ref, ref + 0.05):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])

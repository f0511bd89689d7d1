"""The JAX package's own runs of phase 20's legs on the CPU, as the
references of the port's (``chip_smoke.py``).

    JAX_PLATFORMS=cpu python3 -m dev.contrib_reference hsgp [chains warmup samples \\
        warmup_depth sample_depth [keys...]]
    JAX_PLATFORMS=cpu python3 -m dev.contrib_reference shells [keys...]
    JAX_PLATFORMS=cpu python3 -m dev.contrib_reference conjugate [keys...]

Run from the root of the repo.

- ``hsgp``: ``examples/hsgp_example.py``'s model on the example's data
  (``chip_smoke.hsgp_data``) under ``NUTS(init_strategy=init_to_median,
  max_tree_depth=(warmup_depth, sample_depth))`` with vectorized chains (by
  default phase 20a's ``HSGP_RUN``), for each key (0 to 4 by default).  The
  model is the example's with the JAX package's own functions
  (``eigenfunctions``, ``diag_spectral_density_squared_exponential``,
  ``linear_approximation``), but for the square root of the spectral
  density, whose gradient is taken as 0 where the density is 0, as the
  port's is: ``jnp.sqrt`` gives NaN there, and the example's model turns
  NUTS back from ``length`` above about 0.68 (``--as-is`` runs the example's
  model itself, to show that).  Per key: the posterior mean of ``length``
  and ``noise`` with its Monte-Carlo error (``chip_smoke.mc_moments``), the
  largest ``length`` drawn and the divergent transitions; then the first
  key's numbers as ``HSGP_REF``.
- ``shells``: ``examples/gaussian_shells.py``'s model under the JAX
  package's ``NestedSampler`` at phase 20c's ``SHELLS_RUN``, and the
  example's two asserts on ``SHELLS_DRAWS`` equal-weight draws.
- ``conjugate``: the JAX package's sampler at ``NS_CONJ_RUN`` on
  ``tests/contrib/test_nested_sampling.py``'s conjugate model, its log Z
  against the analytic one.
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
import numpyro_tpu.distributions as jdist  # noqa: E402
from examples.gaussian_shells import model as shells_model  # noqa: E402
from examples.hsgp_example import model as example_model  # noqa: E402
from numpyro_tpu.contrib.hsgp.approximation import linear_approximation  # noqa: E402
from numpyro_tpu.contrib.hsgp.laplacian import eigenfunctions  # noqa: E402
from numpyro_tpu.contrib.hsgp.spectral_densities import (  # noqa: E402
    diag_spectral_density_squared_exponential,
)
from numpyro_tpu.contrib.nested_sampling import NestedSampler  # noqa: E402
from numpyro_tpu.infer import MCMC, NUTS, init_to_median  # noqa: E402


def finite_sqrt(spd):
    """``sqrt(spd)`` with a gradient of 0 where ``spd`` is 0."""
    positive = spd > 0
    return jnp.where(positive, jnp.sqrt(jnp.where(positive, spd, 1.0)), 0.0)


def hsgp_model(x, y=None, ell=cs.HSGP_ELL, m=cs.HSGP_M):
    """The example's model, its square root of the density as the port's."""
    amp = numpyro_tpu.sample("amp", jdist.HalfNormal(1.0))
    length = numpyro_tpu.sample("length", jdist.LogNormal(-1.0, 1.0))
    noise = numpyro_tpu.sample("noise", jdist.HalfNormal(0.5))
    phi = eigenfunctions(x=x, ell=ell, m=m)
    spd = finite_sqrt(diag_spectral_density_squared_exponential(
        alpha=amp, length=length, ell=ell, m=m, dim=1))
    f = linear_approximation(phi, spd, phi.shape[-1])
    with numpyro_tpu.plate("N", x.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(f, noise), obs=y)


def hsgp_run(key, chains, warmup, samples, depths, as_is):
    x, y = cs.hsgp_data()
    mcmc = MCMC(NUTS(example_model if as_is else hsgp_model, init_strategy=init_to_median,
                     max_tree_depth=depths),
                num_warmup=warmup, num_samples=samples, num_chains=chains,
                chain_method="vectorized", progress_bar=False)
    t0 = time.perf_counter()
    mcmc.run(random.PRNGKey(key), jnp.asarray(x), jnp.asarray(y), extra_fields=("diverging",))
    z = mcmc.get_samples(group_by_chain=True)
    out = {site: cs.mc_moments(np.asarray(z[site], np.float64)) for site in ("length", "noise")}
    div = int(np.asarray(mcmc.get_extra_fields()["diverging"]).sum())
    print(f"key {key}: {time.perf_counter() - t0:.1f} s, " + "; ".join(
        f"{s} {o['mean']:.4f} +- {o['se_mean']:.4f}" for s, o in out.items())
        + f"; largest length {float(np.max(z['length'])):.4f}; {div} divergent", flush=True)
    return {s: {"mean": round(o["mean"], 4), "se_mean": round(o["se_mean"], 4)}
            for s, o in out.items()}


def shells_run(key):
    ns = NestedSampler(shells_model, constructor_kwargs=cs.SHELLS_RUN)
    t0 = time.perf_counter()
    ns.run(random.PRNGKey(key), jnp.asarray(cs.SHELLS_CENTERS[0]),
           jnp.asarray(cs.SHELLS_CENTERS[1]), cs.SHELLS_RADIUS, cs.SHELLS_WIDTH)
    res = ns.diagnostics()
    samples = np.asarray(ns.get_samples(random.PRNGKey(key + 1), cs.SHELLS_DRAWS)["x"])
    left, median, left_ok, ring_ok = cs.shells_checks(samples)
    print(f"key {key}: {time.perf_counter() - t0:.1f} s, {int(res.num_iterations)} iterations, "
          f"log Z {float(res.log_Z):.4f} +- {float(res.log_Z_err):.4f}; {left:.2%} in the left "
          f"shell ({left_ok}), median distance to the nearest ring {median:.4f} ({ring_ok})",
          flush=True)
    return left_ok and ring_ok


def conjugate_run(key):
    ns = NestedSampler(jax_conjugate, constructor_kwargs=cs.NS_CONJ_RUN)
    ns.run(random.PRNGKey(key), jnp.asarray(cs.NS_Y))
    res = ns.diagnostics()
    truth = cs.conjugate_log_evidence()
    gap, bound = abs(float(res.log_Z) - truth), 3 * float(res.log_Z_err) + 0.05
    print(f"key {key}: {int(res.num_iterations)} iterations, log Z {float(res.log_Z):.4f} +- "
          f"{float(res.log_Z_err):.4f}, analytic {truth:.4f}, gap {gap:.4f} (gate {bound:.4f})",
          flush=True)
    return gap <= bound


def jax_conjugate(y):
    mu = numpyro_tpu.sample("mu", jdist.Normal(0.0, cs.NS_SP))
    with numpyro_tpu.plate("N", y.shape[0]):
        numpyro_tpu.sample("y", jdist.Normal(mu, cs.NS_SO), obs=y)


def main(argv):
    which = argv[0] if argv else "hsgp"
    as_is = "--as-is" in argv
    numbers = [int(a) for a in argv[1:] if not a.startswith("--")]
    if which == "hsgp":
        chains, warmup, samples, dw, ds = numbers[:5] if len(numbers) >= 5 else (
            cs.HSGP_RUN[:3] + cs.HSGP_RUN[3])
        keys = numbers[5:] or [0, 1, 2, 3, 4]
        refs = [hsgp_run(k, chains, warmup, samples, (dw, ds), as_is) for k in keys]
        print(f"hsgp: {chains} chains, {warmup} + {samples}, depths ({dw}, {ds}), key {keys[0]}: "
              f"HSGP_REF = {refs[0]}")
    elif which == "shells":
        keys = numbers or [0, 1, 2, 3, 4]
        held = [shells_run(k) for k in keys]
        print(f"shells at {cs.SHELLS_RUN}: the example's asserts hold for {sum(held)} of "
              f"{len(held)} keys")
    elif which == "conjugate":
        keys = numbers or [0, 1, 2, 3, 4]
        held = [conjugate_run(k) for k in keys]
        print(f"conjugate at {cs.NS_CONJ_RUN}: the gate holds for {sum(held)} of {len(held)} keys")
    else:
        raise SystemExit(f"unknown leg {which!r}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""The JAX package's model inspection of phase 19b's two models on the CPU,
as the literals that ``chip_smoke.py`` holds the port's inspection to
(``INSPECT_REF``).

    JAX_PLATFORMS=cpu python3 -m dev.inspect_reference

Run from the root of the repo.  The models are ``chip_smoke.model`` (the
covtype model: ``w`` and the ``glm_split`` factor, at the full 581,012 x 55
of ``chip_smoke.make_data``'s numpy data, which the JAX package traces
abstractly) and ``chip_smoke.dsl_model`` (phase 18b's model on
``chip_smoke.dsl_data()``), each written here in the JAX package.  For each
it prints, under the keys of ``INSPECT_REF``:

- ``dependencies``: ``numpyro_tpu.infer.inspect.get_dependencies(model,
  args)``;
- ``relations``: ``numpyro_tpu.infer.inspect.get_model_relations(model,
  args)``;
- ``graph``: ``numpyro_tpu.infer.inspect.generate_graph_specification(
  relations)``, as its fields ``(membership, parent, {node: (observed,
  dist_name, constraint)}, edges)``.

The output is a Python literal to paste over ``INSPECT_REF``.
"""

import os
import pprint
import sys
from functools import partial

import numpy as np

import jax.numpy as jnp

import numpyro_tpu as jnpt
import numpyro_tpu.distributions as jdist
from numpyro_tpu import handlers as jhandlers
from numpyro_tpu.contrib.control_flow import cond as jcond
from numpyro_tpu.infer import inspect as jinspect
from numpyro_tpu.ops import glm as jglm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def covtype_model(data):
    """``chip_smoke.model`` in the JAX package."""
    w = jnpt.sample("w", jdist.Normal(jnp.zeros(cs.D), 1.0).to_event(1))
    jnpt.factor("lik", jglm.bernoulli_logits_loglik(w, data))


# the JAX package's ``scale`` checks its factor with ``jnp`` in ``__init__``,
# which raises under the abstract trace of inspection (a tracer read as a
# bool; ROADMAP Queue 3), so the model's handler is made once, outside it
HALF = jhandlers.scale(scale=0.5)


def dsl_model(y):
    """``chip_smoke.dsl_model`` in the JAX package (its ``scale`` handler is
    ``HALF``)."""
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
    with jhandlers.scope(prefix="dsl"), HALF, jnpt.plate_stack("grid", tuple(y.shape)):
        jnpt.sample("y", jdist.Normal(mu[:, None] + shift, sigma), obs=obs, obs_mask=mask)


def graph_fields(spec):
    return (spec.membership, spec.parent,
            {k: (n.observed, n.dist_name, n.constraint) for k, n in spec.nodes.items()},
            spec.edges)


def inspect(model, args):
    relations = jinspect.get_model_relations(model, args)
    return {
        "dependencies": jinspect.get_dependencies(model, args),
        "relations": relations,
        "graph": graph_fields(jinspect.generate_graph_specification(relations)),
    }


def main():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((cs.N, cs.D - 1), dtype=np.float32)
    X = np.concatenate([x, np.ones((cs.N, 1), np.float32)], axis=1)
    y = (rng.random(cs.N) < 0.5).astype(np.float32)  # inspection reads no value
    data = jglm.prepare_glm_data(jnp.asarray(X), jnp.asarray(y), dtype="split")
    out = {"covtype": inspect(covtype_model, (data,)),
           "dsl": inspect(dsl_model, (jnp.asarray(cs.dsl_data()),))}
    prefix = "INSPECT_REF = "
    text = pprint.pformat(out, width=96 - len(prefix), sort_dicts=False)
    print(prefix + text.replace("\n", "\n" + " " * len(prefix)))


if __name__ == "__main__":
    main()

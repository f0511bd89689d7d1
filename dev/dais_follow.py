"""``AutoDAIS`` training in the port on the JAX package's draws, step by step,
against the JAX package's own training: the comparison of
``tests/test_torch_dais.py::test_dais_training_follows_jax_on_jax_draws``
at the length and particle count of ``dev.dais_spread``.

    JAX_PLATFORMS=cpu python3 -m dev.dais_follow [steps [particles]]

Run from the root of the repo, on the CPU (100 steps and 8 particles by
default, about 4 minutes).  Both packages train ``AutoDAIS(K=4)`` with
``Adam(5e-3)`` on ``examples/dais_demo.py``'s model from w = 0; every step
the port's ``torch.randn`` returns the draws that JAX's guide made at that
step.  Every tenth step it prints the loss's relative gap, the largest gap of
the unconstrained params over ``1e-5 + 1e-4 |x|`` (under 1: within the test's
tolerance) and the learned ``eta_coeff`` of both; last, the worst gap.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))
import test_torch_dais as T  # noqa: E402
from test_torch_svi import _guide_seeds  # noqa: E402

from numpyro_tpu import infer as jinfer  # noqa: E402
from numpyro_tpu import optim as joptim  # noqa: E402
from numpyro_tpu.infer import autoguide as jautoguide  # noqa: E402
from numpyro_tpu.infer.initialization import init_to_value as jinit_to_value  # noqa: E402
from numpyro_tpu_torch import optim  # noqa: E402
from numpyro_tpu_torch.infer import SVI, Trace_ELBO, autoguide, init_to_value  # noqa: E402


def main(argv):
    steps = int(argv[0]) if argv else 100
    P = int(argv[1]) if len(argv) > 1 else 8
    patch = pytest.MonkeyPatch()
    X, y = T._demo_data()
    jX, jy, tX, ty = jnp.asarray(X), jnp.asarray(y), torch.from_numpy(X), torch.from_numpy(y)
    jguide = jautoguide.AutoDAIS(T.demo_model_j, K=4,
                                 init_loc_fn=jinit_to_value(values={"w": jnp.zeros(2)}))
    tguide = autoguide.AutoDAIS(T.demo_model_t, K=4,
                                init_loc_fn=init_to_value(values={"w": torch.zeros(2)}))
    jsvi = jinfer.SVI(T.demo_model_j, jguide, joptim.Adam(5e-3), jinfer.Trace_ELBO(P))
    jopt = jsvi.init(random.PRNGKey(0), jX, jy)[0]
    tsvi = SVI(T.demo_model_t, tguide, optim.Adam(5e-3), Trace_ELBO(P), device="cpu")
    topt = tsvi.init(0, tX, ty).optim_state
    jloss = jinfer.Trace_ELBO(P)
    jvg = jax.jit(jax.value_and_grad(
        lambda u, key: jloss.loss(key, jsvi.constrain_fn(u), T.demo_model_j, jguide, jX, jy)))
    t0, worst = time.perf_counter(), 0.0
    for t in range(steps):
        key = random.fold_in(random.PRNGKey(1), t)
        uj = jsvi.optim.get_params(jopt)
        jval, jgrad = jvg(uj, key)
        noise = T._dais_noise(jguide, jsvi.constrain_fn(uj), _guide_seeds(key, P, True),
                              (jX, jy), False)
        ut = {k: v.numpy() for k, v in tsvi.optim.get_params(topt).items()}
        tval, tgrad = T._torch_value_and_grad(tsvi, T.demo_model_t, tguide, (tX, ty), ut, noise,
                                              P, patch)
        jopt = jsvi.optim.update(jgrad, jopt)
        topt = tsvi.optim.update(tgrad, topt)
        uj, ut = jsvi.optim.get_params(jopt), tsvi.optim.get_params(topt)
        gap = max(float(np.max(np.abs(np.asarray(uj[k]) - ut[k].numpy())
                               / (1e-5 + 1e-4 * np.abs(np.asarray(uj[k]))))) for k in uj)
        worst = max(worst, gap)
        if t % 10 == 9:
            print(f"step {t + 1}: loss gap {abs(tval - float(jval)) / abs(float(jval)):.2e}, "
                  f"params gap {gap:.3f}, eta_coeff JAX {float(uj['auto_eta_coeff']):.5f} port "
                  f"{ut['auto_eta_coeff'].item():.5f}", flush=True)
    print(f"{steps} steps, {P} particles in {time.perf_counter() - t0:.1f} s: worst params gap "
          f"{worst:.3f} of the tolerance")


if __name__ == "__main__":
    main(sys.argv[1:])

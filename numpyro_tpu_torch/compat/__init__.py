"""The pyro-api generic interface backed by the port (port of
``numpyro_tpu/compat``): ``distributions``, ``handlers``, ``infer``, ``ops``,
``optim`` and ``pyro``.  Registers the backend ``numpyro_tpu_torch`` with
``pyroapi`` when that package imports."""

from numpyro_tpu_torch.compat import distributions, handlers, infer, ops, optim, pyro

try:
    from pyroapi import register_backend
except ImportError:
    pass
else:  # pragma: no cover - pyroapi is not installed where the tests run
    register_backend(
        "numpyro_tpu_torch",
        {
            "distributions": "numpyro_tpu_torch.compat.distributions",
            "handlers": "numpyro_tpu_torch.compat.handlers",
            "infer": "numpyro_tpu_torch.compat.infer",
            "ops": "numpyro_tpu_torch.compat.ops",
            "optim": "numpyro_tpu_torch.compat.optim",
            "pyro": "numpyro_tpu_torch.compat.pyro",
        },
    )

__all__ = ["distributions", "handlers", "infer", "ops", "optim", "pyro"]

"""The public names of the port's modules against the JAX package's: the
package root, ``handlers``, ``distributions``, ``ops``, ``ops.indexing`` and
``contrib.control_flow`` carry every name of the JAX module's ``__all__``
but those ROADMAP.md leaves out: its "Not to port" list and the names of
the queue items still to come, each named below with its item."""

import inspect

import pytest

import numpyro_tpu
import numpyro_tpu_torch

# the JAX package's names the port does not carry yet, or at all (ROADMAP.md)
LEFT_OUT = {
    "": {
        "get_dependencies": "Queue 1 item 7 (infer/inspect.py)",
        "render_model": "Queue 1 item 7 (infer/inspect.py)",
        "checkpoint": "Queue 1 item 9",
        "compat": "Queue 1 item 9",
        "enable_x64": "Queue 1 item 9 (util.py's helpers)",
        "set_host_device_count": "Queue 1 item 9 (util.py's helpers)",
        "set_platform": "Queue 1 item 9 (util.py's helpers)",
    },
    "ops": {"PytreeTrace": "Not to port (ops/pytree.py carries a trace through lax control flow)"},
}
# modules of the port that the JAX module's __all__ does not list
PORT_ONLY = {"": {"nn"}, "ops": {"glm"}}

MODULES = ["", "handlers", "distributions", "ops", "ops.indexing", "contrib.control_flow"]


def _module(package, name):
    module = package
    for part in filter(None, name.split(".")):
        module = getattr(module, part)
    return module


def _public(module):
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and (inspect.isclass(v) or inspect.isfunction(v))
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("name", MODULES)
def test_the_port_carries_the_jax_module_s_names(name):
    import numpyro_tpu.contrib.control_flow  # noqa: F401
    import numpyro_tpu.ops.indexing  # noqa: F401
    import numpyro_tpu_torch.contrib.control_flow  # noqa: F401
    import numpyro_tpu_torch.ops.indexing  # noqa: F401

    jax_names = _public(_module(numpyro_tpu, name))
    port_names = _public(_module(numpyro_tpu_torch, name))
    left_out = set(LEFT_OUT.get(name, {}))
    assert left_out <= jax_names
    assert port_names == (jax_names - left_out) | PORT_ONLY.get(name, set())
    module = _module(numpyro_tpu_torch, name)
    assert all(hasattr(module, n) for n in port_names)

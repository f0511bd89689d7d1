"""The public names of the port's modules against the JAX package's: the
package root, ``handlers``, ``distributions``, ``distributions.constraints``,
``ops``, ``ops.indexing``, ``contrib.control_flow``, ``contrib.einstein``,
``contrib.hsgp`` (and its ``laplacian`` and ``spectral_densities``),
``contrib.nested_sampling``, ``contrib.stochastic_support``, ``infer``, ``infer.util``,
``infer.initialization``, ``infer.hmc``, ``infer.inspect`` and ``parallel``
carry every name of the JAX module's ``__all__`` but those
ROADMAP.md leaves out: its "Not to port" list and the names of the queue
items still to come, each named below with its item."""

import inspect

import pytest

import numpyro_tpu
import numpyro_tpu_torch

# the JAX package's names the port does not carry yet, or at all (ROADMAP.md)
ONE_CARD = "Not to port (parallel/mesh.py's mesh, sharding and multi-host helpers; one H100)"
LEFT_OUT = {
    "": {
        "checkpoint": "Queue 1 item 3 (checkpoint.py)",
        "compat": "Queue 1 item 3 (compat/)",
        "enable_x64": "Queue 1 item 3 (util.py's helpers)",
        "set_host_device_count": "Queue 1 item 3 (util.py's helpers)",
        "set_platform": "Queue 1 item 3 (util.py's helpers)",
    },
    "ops": {"PytreeTrace": "Not to port (ops/pytree.py carries a trace through lax control flow)"},
    "parallel": {name: ONE_CARD for name in (
        "chain_data_mesh", "chain_mesh", "initialize_distributed", "shard_chain_state",
        "shard_data")},
}
# names in the port's __all__ that the JAX module's does not list
PORT_ONLY = {
    "": {"nn"},
    "ops": {"glm"},
    "distributions.constraints": {"complex", "positive_definite_circulant_vector"},
    "infer.util": {"batched_value", "batched_value_and_grad", "device_generator",
                   "get_importance_trace", "get_potential_fn", "pin_full_f32_matmul",
                   "samples_from_numpy", "state_field", "tqdm_bar", "tree_from_numpy"},
}

MODULES = ["", "handlers", "distributions", "distributions.constraints", "ops", "ops.indexing",
           "contrib.control_flow", "contrib.einstein", "contrib.hsgp", "contrib.hsgp.laplacian",
           "contrib.hsgp.spectral_densities", "contrib.nested_sampling",
           "contrib.stochastic_support", "infer", "infer.util", "infer.initialization", "infer.hmc",
           "infer.inspect", "parallel"]


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
    import numpyro_tpu.contrib.einstein  # noqa: F401
    import numpyro_tpu.contrib.hsgp.laplacian  # noqa: F401
    import numpyro_tpu.contrib.hsgp.spectral_densities  # noqa: F401
    import numpyro_tpu.contrib.nested_sampling  # noqa: F401
    import numpyro_tpu.contrib.stochastic_support  # noqa: F401
    import numpyro_tpu.ops.indexing  # noqa: F401
    import numpyro_tpu.parallel  # noqa: F401
    import numpyro_tpu_torch.contrib.control_flow  # noqa: F401
    import numpyro_tpu_torch.contrib.einstein  # noqa: F401
    import numpyro_tpu_torch.contrib.hsgp.laplacian  # noqa: F401
    import numpyro_tpu_torch.contrib.hsgp.spectral_densities  # noqa: F401
    import numpyro_tpu_torch.contrib.nested_sampling  # noqa: F401
    import numpyro_tpu_torch.contrib.stochastic_support  # noqa: F401
    import numpyro_tpu_torch.ops.indexing  # noqa: F401
    import numpyro_tpu_torch.parallel  # noqa: F401

    jax_names = _public(_module(numpyro_tpu, name))
    port_names = _public(_module(numpyro_tpu_torch, name))
    left_out = set(LEFT_OUT.get(name, {}))
    assert left_out <= jax_names
    assert port_names == (jax_names - left_out) | PORT_ONLY.get(name, set())
    module = _module(numpyro_tpu_torch, name)
    assert all(hasattr(module, n) for n in port_names)

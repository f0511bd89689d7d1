"""The public names of the port's modules against the JAX package's: the
package root, ``util``, ``checkpoint``, ``compat`` and its seven
submodules, ``examples.datasets``, ``handlers``, ``distributions``,
``distributions.constraints``, ``ops``, ``ops.indexing``,
``contrib.control_flow``, ``contrib.einstein``, ``contrib.hsgp`` (and its
``laplacian`` and ``spectral_densities``), ``contrib.module``,
``contrib.nested_sampling``, ``contrib.stochastic_support``, ``infer``,
``infer.util``, ``infer.initialization``, ``infer.hmc``, ``infer.inspect``
and ``parallel`` carry every name of the JAX module's ``__all__`` (or, where
it has none, of its public classes and functions) but those ROADMAP.md
leaves out, each named below with its reason."""

import inspect

import pytest

import numpyro_tpu
import numpyro_tpu_torch

# the JAX package's names the port does not carry (ROADMAP.md, "Not to port")
PLATFORM = "Not to port (sets JAX's platform or XLA's flags; the port takes an explicit device)"
JAX_LOOPS = "Not to port (lax control flow and its debug switch; the port's loops are Python)"
LEFT_OUT = {
    "": {"set_host_device_count": PLATFORM, "set_platform": PLATFORM},
    "util": {
        "set_host_device_count": PLATFORM,
        "set_platform": PLATFORM,
        "cond": JAX_LOOPS,
        "while_loop": JAX_LOOPS,
        "fori_loop": JAX_LOOPS,
        "control_flow_prims_disabled": JAX_LOOPS,
        "cached_by": "Not to port (memoizes jitted programs; the port compiles nothing)",
        "maybe_jit": "Not to port (jax.jit or not; the port compiles nothing)",
        "not_jax_tracer": "Not to port (tells a JAX tracer apart; the port has none)",
        "split_dynamic": "Not to port (splits jit's static and traced arguments)",
        "merge_dynamic": "Not to port (the inverse of split_dynamic)",
        "is_prng_key": "Not to port (JAX's key arrays; the port takes torch.Generator)",
        "profiler_trace": "Not to port (jax.profiler; torch.profiler serves the port)",
        "progress_bar_factory": "Not to port (a bar driven from inside jit by io_callback; "
                                "the port's drivers update tqdm from Python)",
    },
    "contrib.module": {name: "Not to port (they take JAX frameworks' modules)" for name in (
        "flax_module", "haiku_module", "nnx_module", "random_flax_module",
        "random_haiku_module", "random_nnx_module")},
    "ops": {"PytreeTrace": "Not to port (ops/pytree.py carries a trace through lax control flow)"},
}
# names in the port's __all__ that the JAX module's does not list
PORT_ONLY = {
    "": {"nn"},
    "util": {"HostArray", "tree_leaves", "tree_map", "tree_unflatten"},
    # the JAX module binds jnp.array as its tensor; the port defines one
    "compat.ops": {"tensor"},
    "contrib.module": {"params_from_linen", "random_torch_module", "torch_module"},
    "ops": {"glm"},
    "distributions.constraints": {"complex", "positive_definite_circulant_vector"},
    "infer.util": {"batched_value", "batched_value_and_grad", "device_generator",
                   "get_importance_trace", "get_potential_fn", "pin_full_f32_matmul",
                   "samples_from_numpy", "state_field", "tqdm_bar", "tree_from_numpy"},
}

MODULES = ["", "util", "checkpoint", "compat", "compat.distributions", "compat.handlers",
           "compat.infer", "compat.ops", "compat.optim", "compat.pyro", "compat.util",
           "examples.datasets", "handlers", "distributions", "distributions.constraints", "ops",
           "ops.indexing", "contrib.control_flow", "contrib.einstein", "contrib.hsgp",
           "contrib.hsgp.laplacian", "contrib.hsgp.spectral_densities", "contrib.module",
           "contrib.nested_sampling", "contrib.stochastic_support", "infer", "infer.util",
           "infer.initialization", "infer.hmc", "infer.inspect", "parallel"]


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
    import numpyro_tpu.compat  # noqa: F401
    import numpyro_tpu.contrib.control_flow  # noqa: F401
    import numpyro_tpu.contrib.einstein  # noqa: F401
    import numpyro_tpu.contrib.hsgp.laplacian  # noqa: F401
    import numpyro_tpu.contrib.hsgp.spectral_densities  # noqa: F401
    import numpyro_tpu.contrib.module  # noqa: F401
    import numpyro_tpu.contrib.nested_sampling  # noqa: F401
    import numpyro_tpu.contrib.stochastic_support  # noqa: F401
    import numpyro_tpu.examples.datasets  # noqa: F401
    import numpyro_tpu.ops.indexing  # noqa: F401
    import numpyro_tpu.parallel  # noqa: F401
    import numpyro_tpu_torch.contrib.control_flow  # noqa: F401
    import numpyro_tpu_torch.contrib.einstein  # noqa: F401
    import numpyro_tpu_torch.contrib.hsgp.laplacian  # noqa: F401
    import numpyro_tpu_torch.contrib.hsgp.spectral_densities  # noqa: F401
    import numpyro_tpu_torch.contrib.module  # noqa: F401
    import numpyro_tpu_torch.contrib.nested_sampling  # noqa: F401
    import numpyro_tpu_torch.contrib.stochastic_support  # noqa: F401
    import numpyro_tpu_torch.examples.datasets  # noqa: F401
    import numpyro_tpu_torch.ops.indexing  # noqa: F401
    import numpyro_tpu_torch.parallel  # noqa: F401

    jax_names = _public(_module(numpyro_tpu, name))
    port_names = _public(_module(numpyro_tpu_torch, name))
    left_out = set(LEFT_OUT.get(name, {}))
    assert left_out <= jax_names
    assert port_names == (jax_names - left_out) | PORT_ONLY.get(name, set())
    module = _module(numpyro_tpu_torch, name)
    assert all(hasattr(module, n) for n in port_names)


def test_only_names_not_to_port_are_left_out():
    """Every module of the JAX package is ported: what the port leaves out
    is on ROADMAP.md's "Not to port" list, and the root leaves out only the
    platform switches."""
    assert set(LEFT_OUT[""]) == {"set_host_device_count", "set_platform"}
    for names in LEFT_OUT.values():
        assert all(reason.startswith("Not to port") for reason in names.values())

"""Model -> density bridge (port of ``numpyro_tpu/infer/util.py``:
``log_density``, ``compute_log_probs``, ``potential_energy``,
``constrain_fn``, ``unconstrain_fn``, ``transform_fn``, ``get_transforms``,
``find_valid_initial_params``, ``initialize_model``,
``_without_rsample_stop_gradient``, ``get_importance_trace``,
``Predictive`` and ``log_likelihood``).

A model with discrete latent sites of finite support is enumerated, as in
the JAX package: ``initialize_model`` wraps it in ``contrib.enum.enum``,
its potential is ``contrib.enum.log_density`` with those sites summed out,
and its params and samples are its continuous sites.

The potential of a model is written for ONE chain, as in the JAX package;
:func:`batched_value_and_grad` maps it over the leading chain axis with
``torch.func.vmap(torch.func.grad_and_value(...))`` (``jacfwd`` in place of
``grad_and_value`` in forward mode).  The trace built under ``vmap`` never
leaves the potential: only the summed log density does.

A model with a ``deterministic`` site is replayed to recover it: its
postprocessing is :func:`constrain_fn` of one draw, which ``MCMC`` maps over
chains and draws.  ``Predictive`` and ``log_likelihood`` map a one-draw
function over the batch with ``util.soft_vmap``; all their draws come from
one ``torch.Generator``, which decides their device.

Over a data shard's rows (``parallel.shard_data``) every latent is whole on
every rank, a latent with a value a row too: its sample site carries the
whole data's distribution (``primitives.sample``), so the init strategies
draw it whole, its support's bijection maps it whole, and its samples are
whole.  ``Predictive`` returns the rank's rows of such a site's draw, and
``log_likelihood`` the rank's rows of each observed site's terms, tagged.
"""

from __future__ import annotations

import math
import warnings
from collections import namedtuple
from functools import partial

import numpy as np
import torch

from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.contrib import enum as contrib_enum
from numpyro_tpu_torch.distributions import constraints
from numpyro_tpu_torch.distributions.transforms import biject_to
from numpyro_tpu_torch.distributions.util import broadcast_shape, sum_rightmost
from numpyro_tpu_torch.infer.initialization import init_to_uniform
from numpyro_tpu_torch.parallel.data_shard import cut_rows, distribution_shard, shard_of
from numpyro_tpu_torch.primitives import Messenger, factor
from numpyro_tpu_torch.util import identity, soft_vmap, tree_leaves, tree_map

__all__ = [
    "Predictive",
    "batched_value",
    "batched_value_and_grad",
    "constrain_fn",
    "device_generator",
    "find_valid_initial_params",
    "get_importance_trace",
    "get_potential_fn",
    "get_transforms",
    "initialize_model",
    "log_density",
    "log_likelihood",
    "pin_full_f32_matmul",
    "potential_energy",
    "samples_from_numpy",
    "state_field",
    "tqdm_bar",
    "transform_fn",
    "tree_from_numpy",
    "unconstrain_fn",
]

ModelInfo = namedtuple(
    "ModelInfo", ["param_info", "potential_fn", "postprocess_fn", "model_trace"]
)
ParamInfo = namedtuple("ParamInfo", ["z", "potential_energy", "z_grad"])

# batched potential-and-gradient evaluations made through
# batched_value_and_grad (init search and every leapfrog); MCMC reports the
# count of a run in ``last_run_stats["potential_evals"]``
potential_evals = 0


def _has_integer_scalars(trees):
    """Whether any chain-batched leaf of ``trees`` is an integer scalar per
    chain (a ``(C,)`` integer tensor): a discrete Gibbs site's value."""
    return any(
        x.dim() == 1 and not x.is_floating_point() for t in trees for x in tree_leaves(t)
    )


def _vmap_then_autograd(fn, batched, *per_chain):
    """Values and gradients of a chain-batched call by reverse-mode autograd
    through ``vmap(fn)`` (the chains' potentials are independent, so the
    gradient of their sum is each chain's own)."""
    with torch.enable_grad():
        params = tree_map(lambda x: x.detach().requires_grad_(), batched)
        leaves = tree_leaves(params)
        value = torch.func.vmap(fn)(params, *per_chain)
        grads = iter(torch.autograd.grad(value.sum(), leaves, allow_unused=True))
    grad = tree_map(lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(next(grads)),
                    params)
    return value.detach(), grad


def batched_value_and_grad(fn, forward_mode=False):
    """``fn`` maps one chain's params (and one chain's slice of any further
    pytrees) to a scalar; the result maps chain-batched pytrees to
    ``(values (C,), grads like the first)``.

    ``forward_mode`` takes the gradient with ``jacfwd`` (one tangent per
    parameter, pushed forward together under ``vmap``), whose auxiliary output
    carries the value, as the JAX package's ``jacfwd`` branch does.

    Where a further pytree holds an integer scalar per chain (a discrete Gibbs
    site, which a model may use as an index, ``locs[c]``), reverse mode runs
    ordinary autograd through ``vmap(fn)``: under ``vmap(grad(...))`` PyTorch
    reads such an index with ``.item()``, which the transform refuses."""
    if forward_mode:
        vg = torch.func.vmap(torch.func.jacfwd(lambda *a: (fn(*a),) * 2, has_aux=True))
    else:
        vg = torch.func.vmap(torch.func.grad_and_value(fn))

    def call(batched, *per_chain):
        global potential_evals
        potential_evals += 1
        if not forward_mode and per_chain and _has_integer_scalars(per_chain):
            return _vmap_then_autograd(fn, batched, *per_chain)
        grad, value = vg(batched, *per_chain)  # torch.func returns (grad, value)
        if forward_mode:
            # PyTorch pushes the tangent of a 0-d tensor through an op with a
            # Python number in float64: each gradient takes its site's dtype
            grad = tree_map(lambda g, p: g.to(p.dtype), grad, batched)
        return value, grad

    return call


def batched_value(fn):
    """``fn`` maps one element's params (and one element's slice of any
    further pytrees) to a scalar; the result maps batched pytrees to the
    values ``(B,)``, for the kernels that take no gradient (SMC, SA and the
    ensembles).  Each call counts as one batched potential evaluation."""
    vfn = torch.func.vmap(fn)

    def call(batched, *rest):
        global potential_evals
        potential_evals += 1
        return vfn(batched, *rest)

    return call


def tqdm_bar(total):
    """A ``tqdm`` bar of ``total`` steps for the drivers, or ``None`` where
    ``tqdm`` is not installed: the run then goes on without a bar, as in
    the JAX package."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return None
    return tqdm(total=total)


def pin_full_f32_matmul():
    """Keep f32 matmuls out of TF32, the counterpart of the JAX ``MCMC``'s
    ``matmul_precision="highest"``: truncated products bias the gradients
    enough to distort the posterior, and a dense mass matrix multiplies the
    momentum at every leapfrog."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_generator(rng_key, device, owner):
    """The generator of a run on ``device``: made from an int seed there, or
    the caller's, which must live there.  Raises when ``device`` is a CUDA
    device and none is available: a run never carries on on the CPU."""
    if isinstance(rng_key, torch.Generator):
        if rng_key.device.type != device.type or (
            device.index is not None and rng_key.device.index != device.index
        ):
            raise ValueError(
                f"rng_key lives on {rng_key.device} and the run on {device}; "
                f"give {owner} that device or an int seed"
            )
    elif isinstance(rng_key, bool) or not isinstance(rng_key, int):
        raise TypeError("rng_key must be an int seed or a torch.Generator")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner} runs on {device} and no CUDA device is available; "
            f"pass device='cpu' to {owner} to run on the CPU"
        )
    if isinstance(rng_key, int):
        return torch.Generator(device=device).manual_seed(rng_key)
    return rng_key


def _site_log_prob(site, *, check_shapes=False):
    """Scaled elementwise log-prob of one sample site; a draw made with its
    intermediates (``TransformedDistribution``) is scored with them.  Over a
    rank's rows of a data shard it holds those rows, tagged; its sum is the
    whole data's (``parallel.data_shard``)."""
    value = site["value"]
    if site.get("intermediates"):
        lp = site["fn"].log_prob(value, site["intermediates"])
    else:
        if check_shapes:
            # an observed or conditioned value may be a Python number
            fn_shape, value_shape = tuple(site["fn"].shape()), tuple(np.shape(value))
            shard = distribution_shard(site["fn"]) or shard_of(value)
            if shard is not None and shard.partial:
                # a whole value or distribution meets the rank's rows of the other
                fn_shape, value_shape = (tuple(shard.rows if n == shard.size else n for n in s)
                                         for s in (fn_shape, value_shape))
            try:
                broadcast_shape(value_shape, fn_shape)
            except RuntimeError:
                raise ValueError(
                    f"Model and guide shapes disagree at site: "
                    f"'{site['name']}': {fn_shape} vs {value_shape}"
                )
        lp = site["fn"].log_prob(value)
    if site["scale"] is not None:
        lp = site["scale"] * lp
    return lp


def _traced_log_probs(model, model_args, model_kwargs, params, **lp_kwargs):
    """``(site name -> scaled elementwise log-prob, trace)`` for every sample
    site of the model run with ``params`` substituted."""
    model = handlers.substitute(model, data=params)
    trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    lps = {
        name: _site_log_prob(site, **lp_kwargs)
        for name, site in trace.items()
        if site["type"] == "sample"
    }
    return lps, trace


def log_density(model, model_args, model_kwargs, params):
    """Sum of the scaled log-probs of all sample sites given substituted
    params; returns ``(log_joint, model_trace)``."""
    lps, trace = _traced_log_probs(model, model_args, model_kwargs, params, check_shapes=True)
    log_joint = 0.0
    for lp in lps.values():
        log_joint = log_joint + lp.sum()
    return log_joint, trace


def compute_log_probs(model, model_args, model_kwargs, params, batch_ndims=0):
    """Each sample site's scaled log-prob given substituted params, summed
    over all its dims (``batch_ndims=0``) or over all but its leading
    ``batch_ndims``; returns ``(dict by site, model_trace)``.  A site with
    no more than ``batch_ndims`` dims is left as it is, as in the JAX
    package."""
    lps, trace = _traced_log_probs(model, model_args, model_kwargs, params)
    reduced = {
        name: lp.sum() if batch_ndims == 0 else sum_rightmost(lp, max(lp.dim() - batch_ndims, 0))
        for name, lp in lps.items()
    }
    return reduced, trace


class _without_rsample_stop_gradient(Messenger):
    """Stop the gradient through the draws of sites whose samplers are not
    reparameterised."""

    def postprocess_message(self, msg):
        if msg["type"] == "sample" and not msg["is_observed"] and not msg["fn"].has_rsample:
            msg["value"] = msg["value"].detach()


def get_importance_trace(model, guide, args, kwargs, params):
    """Run the guide, replay the model against it; return both traces, each
    sample site with its scaled ``log_prob``."""
    guide = handlers.substitute(guide, data=params)
    with _without_rsample_stop_gradient():
        guide_trace = handlers.trace(guide).get_trace(*args, **kwargs)
    model = handlers.substitute(handlers.replay(model, guide_trace), data=params)
    model_trace = handlers.trace(model).get_trace(*args, **kwargs)
    for site in [*guide_trace.values(), *model_trace.values()]:
        if site["type"] == "sample" and "log_prob" not in site:
            site["log_prob"] = _site_log_prob(site)
    return model_trace, guide_trace


def transform_fn(transforms, params, invert=False):
    """Apply (or invert) a dict of per-site transforms to params."""

    def pick(name):
        t = transforms.get(name)
        if t is None:
            return identity
        return t.inv if invert else t

    return {name: pick(name)(value) for name, value in params.items()}


def constrain_fn(model, model_args, model_kwargs, params, return_deterministic=False):
    """Map unconstrained params onto the supports of their sites by running
    the model with them; with ``return_deterministic`` the model's
    deterministic sites come back too."""

    def substitute_fn(site):
        given = params.get(site["name"])
        if given is None or site["type"] != "sample":
            return given
        return biject_to(site["fn"].support)(given)

    substituted_model = handlers.substitute(model, substitute_fn=substitute_fn)
    model_trace = handlers.trace(substituted_model).get_trace(*model_args, **model_kwargs)
    return {
        name: site["value"]
        for name, site in model_trace.items()
        if name in params or (return_deterministic and site["type"] == "deterministic")
    }


def unconstrain_fn(model, model_args, model_kwargs, params):
    """Map constrained params of latent sites into unconstrained space."""
    model = handlers.substitute(model, data=params)
    model_trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    transforms = {
        name: biject_to(site["fn"].support)
        for name, site in model_trace.items()
        if site["type"] == "sample" and not site["is_observed"]
        and site["fn"].support is not None
    }
    return transform_fn(transforms, params, invert=True)


def samples_from_numpy(samples, device="cpu"):
    """The port's tensors, on ``device`` and in their own dtypes, from a dict
    of arrays: the JAX package's posterior samples (``MCMC.get_samples``,
    grouped by chain or not) or SVI params (``SVI.get_params``), moved over
    as numpy arrays."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in samples.items()}


def tree_from_numpy(x, device="cpu"):
    """numpy arrays (or numbers) in dicts, tuples and lists -> tensors on
    ``device``, for the ``*_state_from_numpy`` converters of the kernels'
    states; narrow integers become ``int64``, the port's index dtype."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: tree_from_numpy(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(tree_from_numpy(v, device) for v in x)
    t = torch.from_numpy(np.array(x))
    if t.dtype in (torch.int32, torch.int16, torch.uint8):
        t = t.to(torch.int64)
    return t.to(device)


def state_field(fields, name):
    """A field of a state given as a namedtuple or a mapping."""
    return fields[name] if isinstance(fields, dict) else getattr(fields, name)


def _unconstrain_reparam(params, site):
    """Substitute-fn that maps unconstrained values into site supports and
    adds log|det J| as a factor: the inner transformation of
    :func:`potential_energy`."""
    name = site["name"]
    if name not in params:
        return None
    p = params[name]
    if site["type"] != "sample":
        return p
    support = site["fn"].support
    t = biject_to(support)
    # inside a scan, a step's site takes its slice of the whole series
    i = site["infer"].get("_scan_current_index") if "infer" in site else None
    if i is not None:
        shift = t.codomain.event_dim - t.domain.event_dim
        if p.dim() > len(site["fn"].shape()) - shift:
            p = p[i]
    base = (
        support.base_constraint
        if isinstance(support, constraints._IndependentConstraint)
        else support
    )
    if isinstance(base, constraints._Real):
        return p  # identity transform: no jacobian term
    value = t(p)
    log_det = t.log_abs_det_jacobian(p, value)
    log_det = sum_rightmost(
        log_det, log_det.dim() - value.dim() + len(site["fn"].event_shape)
    )
    factor(f"_{name}_log_det", log_det)
    return value


def potential_energy(model, model_args, model_kwargs, params, enum=False):
    """-log p(constrained(params)) - log|det J|: the NUTS target.  With
    ``enum`` the model runs under ``contrib.enum.enum`` and its discrete
    sites are summed out (``contrib.enum.log_density``)."""
    density_fn = contrib_enum.log_density if enum else log_density
    reparamed = handlers.substitute(
        model, substitute_fn=partial(_unconstrain_reparam, params)
    )
    log_joint, _ = density_fn(reparamed, model_args, model_kwargs, {})
    return -log_joint


def _finite_per_chain(pe, grad):
    ok = torch.isfinite(pe)
    if grad is None:
        return ok
    for g in grad.values():
        ok = ok & torch.isfinite(g.reshape(g.shape[0], -1)).all(-1)
    return ok


def chain_generators(rng_key, device, num_chains):
    """The generators of a run's chains, one each: chain ``i``'s is seeded
    with the ``i``-th of ``num_chains`` integers drawn from the run's
    generator (made from ``rng_key`` on ``device`` as ``MCMC.run`` makes
    it).  A ``"sequential"`` run and a batched init search under any
    strategy but ``init_to_uniform`` draw chain ``i``'s values on its
    generator."""
    generator = device_generator(rng_key, device, "MCMC")
    seeds = torch.randint(0, 2**62, (num_chains,), generator=generator, device=device).tolist()
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


# model traces made by the init search (``initialize_model``'s first trace
# and every candidate traced under a strategy); a traced model evaluates its
# likelihood, so a kernel in it launches once per trace
init_traces = 0


def _trace_candidate(model, strategy, rng_key, model_args, model_kwargs):
    """One candidate: the model traced under ``strategy`` with the sites'
    draws on ``rng_key``, each continuous latent value pulled back through
    its support's bijection."""
    global init_traces
    init_traces += 1
    strategized = handlers.substitute(handlers.seed(model, rng_key), substitute_fn=strategy)
    trace = handlers.trace(strategized).get_trace(*model_args, **model_kwargs)
    return {
        name: biject_to(site["fn"].support).inv(site["value"])
        for name, site in trace.items()
        if site["type"] == "sample" and not site["is_observed"]
        and not site["fn"].support.is_discrete
    }


def _uniform_radius(strategy, prototype_params):
    """The radius of ``init_to_uniform`` where the search may draw its box
    in unconstrained space directly (a prototype gives the shapes), else
    ``None``."""
    if getattr(strategy, "func", None) is init_to_uniform and prototype_params is not None:
        return strategy.keywords.get("radius", 2.0)
    return None


def _single_chain_search(rng_key, model, strategy, model_args, model_kwargs,
                        prototype_params, forward_mode, validate_grad, enum):
    """One chain, unbatched: draw until the potential (and, with
    ``validate_grad``, its gradient) is finite, at most 100 tries.
    ``init_to_uniform`` draws in unconstrained space directly; any other
    strategy traces the model under it and pulls each latent value back
    through its support's bijection."""
    radius = _uniform_radius(strategy, prototype_params)

    def draw():
        if radius is not None:
            return {
                name: (torch.rand(tuple(proto.shape), generator=rng_key, device=rng_key.device,
                                  dtype=proto.dtype) * 2 - 1) * radius
                for name, proto in sorted(prototype_params.items())
            }
        return _trace_candidate(model, strategy, rng_key, model_args, model_kwargs)

    pe_fn = partial(potential_energy, model, model_args, model_kwargs, enum=enum)
    for _ in range(100):
        params = draw()
        if not validate_grad:
            pe, grad = pe_fn(params), None
            ok = torch.isfinite(pe)
        else:
            if forward_mode:
                # as in batched_value_and_grad: each gradient takes its site's dtype
                grad = {k: g.to(params[k].dtype)
                        for k, g in torch.func.jacfwd(pe_fn)(params).items()}
                pe = pe_fn(params)
            else:
                grad, pe = torch.func.grad_and_value(pe_fn)(params)
            ok = torch.isfinite(pe)
            for g in grad.values():
                ok = ok & torch.isfinite(g).all()
        if bool(ok):
            break
    return (params, pe, grad), ok


def _batched_candidates(rng_key, model, strategy, num_chains, model_args, model_kwargs,
                        prototype_params):
    """``(candidates, redraw)``: the first candidates of all chains, ``(C,
    ...)`` per site, and ``redraw(redo)``, which gives fresh ones where the
    ``(C,)`` mask ``redo`` is set (the others are filler), or ``None`` where
    a retry would find the same candidates again.

    ``init_to_uniform`` with a prototype draws the chains' boxes together on
    ``rng_key``.  Any other strategy traces the model once per chain, chain
    ``i`` on its own generator (:func:`chain_generators`), so that chain
    ``i`` finds what a single-chain search on that generator finds; the
    traces run in a loop on the host, because ``torch.func.vmap`` cannot
    thread each chain's generator through the sites' draws.  Where the first
    chain's trace drew nothing from its generator (``init_to_mean``,
    ``init_to_feasible``, ``init_to_value`` with every site given) its
    candidate is every chain's: that one trace is broadcast."""
    radius = _uniform_radius(strategy, prototype_params)
    if radius is not None:

        def draw_box(redo=None):
            return {
                name: (
                    torch.rand(
                        (num_chains,) + tuple(proto.shape), generator=rng_key,
                        device=rng_key.device, dtype=proto.dtype,
                    ) * 2 - 1
                ) * radius
                for name, proto in sorted(prototype_params.items())
            }

        return draw_box(), draw_box
    generators = chain_generators(rng_key, rng_key.device, num_chains)
    trace = partial(_trace_candidate, model, strategy, model_args=model_args,
                    model_kwargs=model_kwargs)
    before = generators[0].get_state()
    first = trace(rng_key=generators[0])
    if torch.equal(generators[0].get_state(), before):
        return {k: v.expand((num_chains,) + tuple(v.shape)).clone()
                for k, v in first.items()}, None

    def stack(parts):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}

    def redraw(redo):
        parts = [trace(rng_key=g) if r else None for g, r in zip(generators, redo.tolist())]
        filler = next(p for p in parts if p is not None)
        return stack([filler if p is None else p for p in parts])

    return stack([first] + [trace(rng_key=g) for g in generators[1:]]), redraw


def find_valid_initial_params(
    rng_key,
    model,
    *,
    num_chains=None,
    init_strategy=init_to_uniform,
    enum=False,
    model_args=(),
    model_kwargs=None,
    prototype_params=None,
    forward_mode_differentiation=False,
    validate_grad=True,
):
    """Draw initial latents until the potential and its gradient are finite
    (at most 100 tries per chain).  ``enum`` scores the enumerated potential
    (a model wrapped by ``initialize_model``): its discrete sites take their
    enumerated values and are never drawn.  ``validate_grad=False`` scores
    the potential alone and returns no gradient.

    ``num_chains=None`` searches for one chain, unbatched.  With
    ``num_chains`` the candidates of all chains are scored in one batched
    evaluation per try, and chains that are already valid keep their params
    while the others draw again (a masked loop in place of the JAX
    package's batched ``while_loop``); how each strategy draws is told at
    :func:`_batched_candidates`.  Returns ``((init_params, pe, grad), is_valid)``,
    with a leading chain axis when ``num_chains`` is given.
    """
    model_kwargs = {} if model_kwargs is None else model_kwargs
    strategy = init_strategy if isinstance(init_strategy, partial) else init_strategy()
    if num_chains is None:
        return _single_chain_search(
            rng_key, model, strategy, model_args, model_kwargs, prototype_params,
            forward_mode_differentiation, validate_grad, enum,
        )
    params, redraw = _batched_candidates(
        rng_key, model, strategy, num_chains, model_args, model_kwargs, prototype_params
    )
    pe_fn = partial(potential_energy, model, model_args, model_kwargs, enum=enum)
    if validate_grad:
        score = batched_value_and_grad(pe_fn, forward_mode=forward_mode_differentiation)
    else:
        value = batched_value(pe_fn)

        def score(params):
            return value(params), None

    pe, grad = score(params)
    ok = _finite_per_chain(pe, grad)
    for _ in range(0 if redraw is None else 99):
        if bool(ok.all()):
            break
        redo = ~ok
        cand = redraw(redo)
        pe_c, grad_c = score(cand)
        pe = torch.where(redo, pe_c, pe)
        for name in params:
            mask = redo.reshape((-1,) + (1,) * (params[name].dim() - 1))
            params[name] = torch.where(mask, cand[name], params[name])
            if grad is not None:
                grad[name] = torch.where(mask, grad_c[name], grad[name])
        ok = ok | _finite_per_chain(pe_c, grad_c)
    return (params, pe, grad), ok


def _get_model_transforms(model, model_args=(), model_kwargs=None):
    model_kwargs = {} if model_kwargs is None else model_kwargs
    model_trace = handlers.trace(model).get_trace(*model_args, **model_kwargs)
    inv_transforms = {}
    replay_model = False
    has_enumerate_support = False
    for name, site in model_trace.items():
        if site["type"] == "sample" and not site["is_observed"]:
            if site["fn"].support.is_discrete:
                enum_type = site["infer"].get("enumerate")
                if enum_type is not None and enum_type != "parallel":
                    raise RuntimeError(
                        "This algorithm might only work for discrete sites with "
                        "enumerate marked 'parallel'."
                    )
                if enum_type is None and not site["fn"].has_enumerate_support:
                    raise RuntimeError(
                        f"MCMC marginalization requires discrete site '{name}' to have "
                        "enumerate support."
                    )
                has_enumerate_support = True
            else:
                inv_transforms[name] = biject_to(site["fn"].support)
        elif site["type"] == "deterministic":
            replay_model = True
    return inv_transforms, replay_model, has_enumerate_support, model_trace


def get_transforms(model, model_args, model_kwargs, params=None):
    """The ``biject_to`` transform of every continuous latent site, by name,
    from one trace of the model (with ``params`` substituted, if given)."""
    substituted = handlers.substitute(model, data=params) if params is not None else model
    inv_transforms, _, _, _ = _get_model_transforms(substituted, model_args, model_kwargs)
    return inv_transforms


def get_potential_fn(
    model, inv_transforms, *, enum=False, replay_model=False, dynamic_args=False,
    model_args=(), model_kwargs=None,
):
    """Build the ``(potential_fn, postprocess_fn)`` closures; with
    ``dynamic_args`` both take the model arguments first.  With
    ``replay_model`` (a model with deterministic sites) the postprocessing
    of one draw replays the model through :func:`constrain_fn`; ``enum``
    makes the potential the enumerated one."""

    def postprocess(args, kwargs):
        if replay_model:
            return partial(constrain_fn, model, args, kwargs, return_deterministic=True)
        return partial(transform_fn, inv_transforms)

    if dynamic_args:

        def potential_fn(*args, **kwargs):
            return partial(potential_energy, model, args, kwargs, enum=enum)

        def postprocess_fn(*args, **kwargs):
            return postprocess(args, kwargs)

        return potential_fn, postprocess_fn
    model_kwargs = {} if model_kwargs is None else model_kwargs
    return (
        partial(potential_energy, model, model_args, model_kwargs, enum=enum),
        postprocess(model_args, model_kwargs),
    )


def initialize_model(
    rng_key,
    model,
    *,
    num_chains=None,
    init_strategy=init_to_uniform,
    dynamic_args=False,
    model_args=(),
    model_kwargs=None,
    forward_mode_differentiation=False,
    validate_grad=True,
):
    """Trace the model, build the potential/postprocess closures and find
    valid initial params for ``num_chains`` chains (one unbatched chain for
    ``None``).  ``rng_key`` is a ``torch.Generator`` on the device the chains
    should live on.  A model with discrete latent sites runs under
    ``enum(config_enumerate(model), -1 - max_plate_nesting)`` from here on:
    its potential sums them out, and the params are its continuous sites."""
    global init_traces
    model_kwargs = {} if model_kwargs is None else model_kwargs
    strategy = init_strategy if isinstance(init_strategy, partial) else init_strategy()
    init_traces += 1
    substituted_model = handlers.substitute(
        handlers.seed(model, rng_key), substitute_fn=strategy
    )
    inv_transforms, replay_model, has_enumerate_support, model_trace = _get_model_transforms(
        substituted_model, model_args, model_kwargs
    )
    if has_enumerate_support:
        max_plate_nesting = _guess_max_plate_nesting(model_trace)
        model = contrib_enum.enum(
            contrib_enum.config_enumerate(model), first_available_dim=-1 - max_plate_nesting
        )
    potential_fn, postprocess_fn = get_potential_fn(
        model,
        inv_transforms,
        enum=has_enumerate_support,
        replay_model=replay_model,
        dynamic_args=dynamic_args,
        model_args=model_args,
        model_kwargs=model_kwargs,
    )
    prototype_params = transform_fn(
        inv_transforms,
        {
            k: v["value"]
            for k, v in model_trace.items()
            if v["type"] == "sample" and not v["is_observed"]
            and not v["fn"].support.is_discrete
        },
        invert=True,
    )
    (init_params, pe, grad), is_valid = find_valid_initial_params(
        rng_key,
        model,
        num_chains=num_chains,
        init_strategy=strategy,
        enum=has_enumerate_support,
        model_args=model_args,
        model_kwargs=model_kwargs,
        prototype_params=prototype_params,
        forward_mode_differentiation=forward_mode_differentiation,
        validate_grad=validate_grad,
    )
    if not bool(is_valid.all()):
        raise RuntimeError(
            "Cannot find valid initial parameters. Please check your model again."
        )
    return ModelInfo(
        ParamInfo(init_params, pe, grad), potential_fn, postprocess_fn, model_trace
    )


def _guess_max_plate_nesting(model_trace):
    """Largest -dim over all plates in a trace."""
    dims = [
        frame.dim
        for site in model_trace.values()
        if site["type"] == "sample"
        for frame in site["cond_indep_stack"]
        if frame.dim is not None
    ]
    return -min(dims) if dims else 0


def _guess_max_plate_nesting_from_model(model, model_args, model_kwargs, rng_key):
    """Trace the model once, seeded, for its deepest plate dim."""
    with handlers.block():
        tr = handlers.trace(handlers.seed(model, rng_key)).get_trace(*model_args, **model_kwargs)
    return _guess_max_plate_nesting(tr)


def _predictive(rng_key, model, posterior_samples, batch_shape, return_sites=None,
                infer_discrete=False, parallel=True, model_args=(), model_kwargs=None):
    """Run ``model`` once per element of ``batch_shape``, each with its
    element of ``posterior_samples`` substituted and the sites it does not
    give drawn from ``rng_key``; returns the chosen sites' values.  With
    ``infer_discrete`` the enumerated discrete sites are drawn from their
    posterior given the element's samples (``contrib.enum.infer_discrete``)."""
    model_kwargs = {} if model_kwargs is None else model_kwargs
    masked_model = handlers.mask(model, mask=False)

    def single_prediction(val):
        _, samples = val
        if infer_discrete:
            conditioned = handlers.substitute(model, samples)
            first_available_dim = -1 - _guess_max_plate_nesting_from_model(
                conditioned, model_args, model_kwargs, rng_key
            )
            sampled_model = contrib_enum.infer_discrete(
                conditioned, first_available_dim=first_available_dim, temperature=1,
                rng_key=rng_key,
            )
            model_trace = handlers.trace(
                handlers.seed(handlers.mask(sampled_model, mask=False), rng_key)
            ).get_trace(*model_args, **model_kwargs)
        else:
            substituted_model = handlers.substitute(masked_model, samples)
            model_trace = handlers.trace(handlers.seed(substituted_model, rng_key)).get_trace(
                *model_args, **model_kwargs
            )
        if return_sites is not None:
            if return_sites == "":
                sites = {k for k, site in model_trace.items() if site["type"] != "plate"}
            else:
                sites = return_sites
        else:
            sites = {
                k
                for k, site in model_trace.items()
                if (site["type"] == "sample" and k not in samples)
                or site["type"] == "deterministic"
            }
        return {name: _rows_returned(site) for name, site in model_trace.items() if name in sites}

    num_samples = math.prod(batch_shape)
    # the element index carries the batch shape, as the JAX package's
    # per-element keys do: a guide's run has no posterior samples
    index = torch.arange(num_samples, device=rng_key.device).reshape(batch_shape)
    chunk_size = num_samples if parallel else 1
    return soft_vmap(single_prediction, (index, posterior_samples), len(batch_shape), chunk_size)


def _rows_returned(site):
    """A site's value as ``Predictive`` returns it: the rank's rows, tagged,
    of a whole site over a data shard's rows (``primitives.sample``)."""
    value, rows = site["value"], site.get("_whole_rows")
    if rows is None or not isinstance(value, torch.Tensor):
        return value
    return cut_rows(value, rows)


def _common_batch_shape(samples, batch_ndims):
    """The leading ``batch_ndims`` axes shared by every site of ``samples``
    (``None`` for no sites); raises where two sites disagree."""
    shape, witness = None, None
    for name, value in samples.items():
        here = tuple(value.shape[:batch_ndims])
        if shape is not None and here != shape:
            raise ValueError(
                f"Batch shapes at site {name} and {witness} should be the "
                f"same, but got {here} and {shape}"
            )
        shape, witness = here, name
    return shape


class Predictive:
    """Draws of a model's sites given posterior samples, or given a guide and
    its params, or from the prior.

    As in the JAX package: ``batch_ndims`` leading axes of the samples make
    the batch (1 by default, 0 with a guide); ``return_sites`` chooses the
    sites (``""``: every site but the plates; by default the sample sites
    that the samples do not give and the deterministic sites);
    ``exclude_deterministic`` is accepted and not used, as the JAX package's
    is, so deterministic sites are always recomputed from the samples;
    ``parallel`` maps the whole batch in one ``vmap``, and so does
    ``parallel=False``, whose chunk of one element ``soft_vmap`` maps whole.

    ``device`` is where the draws are made: ``None`` means ``cuda``, and a
    call raises where that device is not there.  ``rng_key`` is an int seed
    or a ``torch.Generator`` on that device; every draw of a call comes from
    it under ``torch.func.vmap(randomness="different")``.
    ``infer_discrete=True`` draws the enumerated discrete sites from their
    posterior given each sample (forward filtering, backward sampling); it
    raises on the sites of an enumerated ``scan``, which the JAX package
    draws from their prior there.  A call keeps f32 matmuls out of TF32.
    """

    def __init__(
        self,
        model,
        posterior_samples=None,
        *,
        guide=None,
        params=None,
        num_samples=None,
        return_sites=None,
        infer_discrete=False,
        parallel=False,
        batch_ndims=None,
        exclude_deterministic=True,
        device=None,
    ):
        if posterior_samples is None and num_samples is None:
            raise ValueError("Either posterior_samples or num_samples must be specified.")
        if batch_ndims is None:
            # a guide draws fresh latents per call from unbatched params;
            # posterior samples carry a leading sample axis
            batch_ndims = 0 if guide is not None else 1
        posterior_samples = posterior_samples or {}

        batch_shape = _common_batch_shape(posterior_samples, batch_ndims)
        if batch_shape is not None:
            batch_size = math.prod(batch_shape)
            if num_samples is not None and num_samples != batch_size:
                warnings.warn(
                    f"Sample's batch dimension size {batch_size} is different "
                    f"from the provided {num_samples} num_samples argument. "
                    f"Defaulting to {batch_size}.",
                    UserWarning,
                    stacklevel=2,
                )
            num_samples = batch_size
        elif num_samples is None:
            raise ValueError("No sample sites in posterior samples to infer `num_samples`.")
        else:
            batch_shape = (1,) * (batch_ndims - 1) + (num_samples,)

        if return_sites is not None:
            assert isinstance(return_sites, (list, tuple, set))

        self.model = model
        self.posterior_samples = posterior_samples
        self.num_samples = num_samples
        self.guide = guide
        self.params = {} if params is None else params
        self.infer_discrete = infer_discrete
        self.return_sites = return_sites
        self.parallel = parallel
        self.batch_ndims = batch_ndims
        self._batch_shape = batch_shape
        self.exclude_deterministic = exclude_deterministic
        self.device = torch.device("cuda" if device is None else device)

    def _call_with_params(self, rng_key, params, args, kwargs):
        posterior_samples = self.posterior_samples
        if self.guide is not None:
            # return_sites="" asks for every site of the guide
            guide = handlers.substitute(self.guide, params)
            posterior_samples = _predictive(
                rng_key, guide, posterior_samples, self._batch_shape, return_sites="",
                parallel=self.parallel, model_args=args, model_kwargs=kwargs,
            )
        model = handlers.substitute(self.model, self.params)
        return _predictive(
            rng_key, model, posterior_samples, self._batch_shape,
            return_sites=self.return_sites, infer_discrete=self.infer_discrete,
            parallel=self.parallel, model_args=args, model_kwargs=kwargs,
        )

    def __call__(self, rng_key, *args, **kwargs):
        rng_key = device_generator(rng_key, self.device, "Predictive")
        pin_full_f32_matmul()
        if self.batch_ndims == 0 or self.params == {} or self.guide is None:
            return self._call_with_params(rng_key, self.params, args, kwargs)
        if self.batch_ndims == 1:  # batch over parameters
            return torch.func.vmap(
                lambda params: self._call_with_params(rng_key, params, args, kwargs),
                out_dims=1, randomness="different",
            )(self.params)
        raise NotImplementedError


def log_likelihood(model, posterior_samples, *args, parallel=False, batch_ndims=1, **kwargs):
    """The log-probability of every observation of the observed sites, for
    each posterior sample (its leading ``batch_ndims`` axes), as a dict by
    site."""

    def single_loglik(samples):
        substituted = handlers.substitute(model, samples) if isinstance(samples, dict) else model
        trace = handlers.trace(substituted).get_trace(*args, **kwargs)
        return {
            name: site["fn"].log_prob(site["value"])
            for name, site in trace.items()
            if site["type"] == "sample" and site["is_observed"]
        }

    batch_shape = _common_batch_shape(posterior_samples, batch_ndims)
    if batch_shape is None:  # no posterior draws: a single prior evaluation
        batch_shape = (1,) * batch_ndims
        posterior_samples = torch.zeros(batch_shape)
    chunk_size = math.prod(batch_shape) if parallel else 1
    return soft_vmap(single_loglik, posterior_samples, len(batch_shape), chunk_size)

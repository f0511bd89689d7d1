"""Model inspection: dependency graphs, relation summaries and graphviz
rendering (port of ``numpyro_tpu/infer/inspect.py``).

The JAX package traces the model abstractly (``jax.eval_shape``) and reads
the dependencies off the jaxpr.  The port runs the model: one trace under
``seed`` and ``init_to_sample`` gives the sites and their values, and one
run of the per-site log densities on :class:`ops.provenance.ProvenanceTensor`
values (:func:`ops.provenance.eval_provenance`, the pass ``TraceGraph_ELBO``
uses) gives which sites each one depends on.  So the model's arithmetic runs
at its real size, twice, on ``device``: ``None`` means ``cuda``, and a call
raises where that device is not there, as ``MCMC`` does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import torch

import numpyro_tpu_torch.distributions as dist
from numpyro_tpu_torch import handlers
from numpyro_tpu_torch.infer.initialization import init_to_sample
from numpyro_tpu_torch.infer.util import device_generator
from numpyro_tpu_torch.ops.provenance import eval_provenance

__all__ = ["get_dependencies", "get_model_relations", "render_model"]


def _dist_name(fn):
    while isinstance(fn, (dist.Independent, dist.ExpandedDistribution, dist.MaskedDistribution)):
        fn = fn.base_dist
    return type(fn).__name__


def _is_sample_site(msg):
    return msg["type"] == "sample" and msg["fn_name"] != "Delta"


def _generator(device, owner):
    return device_generator(0, torch.device("cuda" if device is None else device), owner)


def _concrete_trace(model, model_args, model_kwargs, generator):
    """The model's trace under ``init_to_sample``, each sample site with the
    name of its distribution (``fn_name``) and deterministic sites named
    ``Deterministic``."""
    subs_model = handlers.substitute(handlers.seed(model, generator), substitute_fn=init_to_sample())
    tr = handlers.trace(subs_model).get_trace(*model_args, **model_kwargs)
    for site in tr.values():
        if site["type"] == "sample":
            site["fn_name"] = _dist_name(site["fn"])
        elif site["type"] == "deterministic":
            site["fn_name"] = "Deterministic"
    return tr


def _site_log_probs(model, model_args, model_kwargs, generator, **sample):
    with handlers.trace() as tr, handlers.seed(rng_seed=generator), \
            handlers.substitute(data=sample):
        model(*model_args, **model_kwargs)
    return {
        name: site["fn"].log_prob(site["value"])
        for name, site in tr.items()
        if site["type"] == "sample"
    }


def get_dependencies(model, model_args=None, model_kwargs=None, *, device=None):
    """Infer the prior and posterior dependency structure of a conditioned
    model (Webb et al. 2018 for the moralization).

    Returns ``{"prior_dependencies": ..., "posterior_dependencies": ...}``,
    each mapping a downstream site to ``{upstream site: set of plates that
    induce dependence across their elements}``.  ``device`` is where the
    model runs (``None``: ``cuda``)."""
    model_args = model_args or ()
    model_kwargs = model_kwargs or {}
    generator = _generator(device, "get_dependencies")

    trace = _concrete_trace(model, model_args, model_kwargs, generator)
    sample_sites = [msg for msg in trace.values() if _is_sample_site(msg)]
    observed = {msg["name"] for msg in sample_sites if msg["is_observed"]}
    plates = {msg["name"]: {f.name for f in msg["cond_indep_stack"]} for msg in sample_sites}

    samples = {
        name: site["value"]
        for name, site in trace.items()
        if site["type"] == "sample" and not site["is_observed"]
    }
    sample_deps = eval_provenance(
        partial(_site_log_probs, model, model_args, model_kwargs, generator), **samples
    )

    # prior graph: site d depends on every earlier latent whose value flowed
    # into d's log-prob (self-edges are kept by convention)
    site_order = [msg["name"] for msg in sample_sites]
    latents_before = {}
    seen = []
    for msg in sample_sites:
        latents_before[msg["name"]] = list(seen)
        if not msg["is_observed"] and msg["fn_name"] != "Unit":
            seen.append(msg["name"])
    prior_dependencies = {
        d: {d: set(), **{u: set() for u in latents_before[d] if u in sample_deps[d]}}
        for d in site_order
    }

    # posterior graph: reverse prior edges into latent nodes, then moralize:
    # each pair of co-parents of d gains an edge carrying the plates over
    # which the dependence is elementwise-dense
    posterior_dependencies = {n: {} for n in plates if n not in observed}
    pos = {name: i for i, name in enumerate(site_order)}
    for d, upstreams in prior_dependencies.items():
        latent_ups = {u: p for u, p in upstreams.items() if u not in observed}
        for u, p in latent_ups.items():
            posterior_dependencies[u][d] = p.copy()
        for u1, p1 in latent_ups.items():
            for u2, p2 in latent_ups.items():
                if pos[u1] < pos[u2]:
                    continue
                dense = posterior_dependencies[u2].setdefault(u1, set())
                dense |= (plates[u1] & plates[u2]) - plates[d]
                dense |= plates[u2] & p1
                dense |= plates[u1] & p2

    return {
        "prior_dependencies": prior_dependencies,
        "posterior_dependencies": posterior_dependencies,
    }


class _substitute_deterministic(handlers.substitute):
    """Give each deterministic site its value from ``data`` and record the
    value it computed as its argument, so that a provenance pass reads what
    the computed value depends on."""

    def process_message(self, msg):
        if msg["type"] == "deterministic":
            msg["args"] = (msg["value"],)
            msg["kwargs"] = {}
            msg["value"] = self.data.get(msg["name"])
            msg["fn"] = lambda x: x


def get_model_relations(model, model_args=None, model_kwargs=None, *, device=None):
    """Summarize the sample, param and plate relations of a model.  Returns a
    dict with keys ``sample_sample``, ``sample_param``, ``sample_dist``,
    ``param_constraint``, ``plate_sample`` and ``observed``.  ``device`` is
    where the model runs (``None``: ``cuda``)."""
    model_args = model_args or ()
    model_kwargs = model_kwargs or {}
    generator = _generator(device, "get_model_relations")

    trace = _concrete_trace(model, model_args, model_kwargs, generator)
    obs_sites, sample_dist, sample_plates = [], {}, {}
    for name, site in trace.items():
        if site["type"] == "sample" and site["is_observed"]:
            obs_sites.append(name)
        if site["type"] in ("sample", "deterministic"):
            sample_dist[name] = site["fn_name"]
            sample_plates[name] = [f.name for f in site["cond_indep_stack"]]
    plate_samples = {
        k: {name for name, ps in sample_plates.items() if k in ps}
        for k, site in trace.items()
        if site["type"] == "plate"
    }

    # partially-overlapping plates cannot nest in a diagram; carve the
    # overlap out of one of them under a __CLONE display marker, repeating
    # until every pair is nested or disjoint
    changed = True
    while changed:
        changed = False
        for p, pv in plate_samples.items():
            for q, qv in plate_samples.items():
                if pv & qv and pv - qv and qv - pv:
                    plate_samples[q] = pv & qv
                    plate_samples[q + "__CLONE"] = qv - pv
                    changed = True
                    break
            if changed:
                break

    plate_samples = {k: [name for name in trace if name in v] for k, v in plate_samples.items()}

    def get_log_probs(**sample):
        with handlers.trace() as tr, handlers.seed(rng_seed=generator):
            with handlers.substitute(data=sample), _substitute_deterministic(data=sample):
                model(*model_args, **model_kwargs)
        out = {}
        for name, site in tr.items():
            if site["type"] == "sample":
                out[name] = site["fn"].log_prob(site["value"])
            elif site["type"] == "deterministic":
                out[name] = site["args"][0]
        return out

    samples = {
        name: site["value"]
        for name, site in trace.items()
        if site["type"] in ("sample", "deterministic")
    }
    params = {name: site["value"] for name, site in trace.items() if site["type"] == "param"}
    deps = eval_provenance(get_log_probs, **samples, **params)

    sample_sample, sample_param = {}, {}
    for name in sample_dist:
        sample_sample[name] = [v for v in sample_dist if v in deps[name] and v != name]
        sample_param[name] = [v for v in deps[name] if v in params]
    param_constraint = {p: str(trace[p]["kwargs"].get("constraint", "")) for p in params}

    return {
        "sample_sample": sample_sample,
        "sample_param": sample_param,
        "sample_dist": sample_dist,
        "param_constraint": param_constraint,
        "plate_sample": plate_samples,
        "observed": obs_sites,
    }


@dataclass
class _Node:
    """One rendered vertex: a random variable, a deterministic site or a
    param."""

    observed: bool = False
    dist_name: str | None = None
    constraint: str = ""

    @property
    def shape(self):
        return "ellipse" if self.dist_name else "box"

    @property
    def fill(self):
        return "grey" if self.observed else "white"


@dataclass
class GraphSpec:
    """The display-level form of a model diagram."""

    membership: dict  # plate name (None = top level) -> list of node names
    parent: dict  # plate -> enclosing plate or None
    nodes: dict  # node name -> _Node
    edges: list  # (source, target) pairs


def generate_graph_specification(model_relations, render_params=False):
    """Convert model relations into a :class:`GraphSpec`."""
    rels = model_relations
    membership = dict(rels["plate_sample"])
    plated = {rv for rvs in membership.values() for rv in rvs}
    membership[None] = [rv for rv in rels["sample_sample"] if rv not in plated]

    nodes = {
        rv: _Node(observed=rv in rels["observed"], dist_name=rels["sample_dist"][rv])
        for rv in rels["sample_sample"]
    }

    edges = [(src, dst) for dst, srcs in rels["sample_sample"].items() for src in srcs]
    if render_params:
        used_params = sorted({p for ps in rels["sample_param"].values() for p in ps})
        membership[None].extend(used_params)
        for p in used_params:
            nodes[p] = _Node(constraint=rels["param_constraint"][p])
        edges += [(src, dst) for dst, srcs in rels["sample_param"].items() for src in srcs]

    # nesting: a plate nests inside any plate whose variable set strictly
    # contains its own (supersets win by iteration order for equal sets)
    parent = {p: None for p in membership if p is not None}
    for a, b in itertools.combinations(membership, 2):
        if a is None or b is None:
            continue
        a_rvs, b_rvs = set(membership[a]), set(membership[b])
        if a_rvs < b_rvs:
            parent[a] = b
        elif a_rvs >= b_rvs:
            parent[b] = a

    return GraphSpec(membership, parent, nodes, edges)


def render_graph(spec, render_distributions=False):
    """Build a ``graphviz.Digraph`` from a :class:`GraphSpec`."""
    try:
        import graphviz
    except ImportError as e:
        raise ImportError(
            "render_model requires the graphviz python package (`pip install graphviz`)."
        ) from e

    def fill(g, plate):
        for name in spec.membership[plate]:
            node = spec.nodes[name]
            g.node(name, label=name, shape=node.shape, style="filled", fillcolor=node.fill)

    def build_cluster(plate):
        """Subgraph for one plate with its children nested inside."""
        g = graphviz.Digraph(name=f"cluster_{plate}")
        g.attr(label=plate.split("__CLONE")[0], labeljust="r", labelloc="b")
        fill(g, plate)
        for child in spec.parent:
            if spec.parent[child] == plate:
                g.subgraph(build_cluster(child))
        return g

    graph = graphviz.Digraph()
    fill(graph, None)
    for plate, enclosing in spec.parent.items():
        if enclosing is None:
            graph.subgraph(build_cluster(plate))
    for src, dst in spec.edges:
        graph.edge(src, dst)

    if render_distributions:
        legend = r"\l".join(
            f"{name} ~ {node.dist_name}" for name, node in spec.nodes.items() if node.dist_name
        )
        graph.node("distribution_description_node", label=legend + r"\l", shape="plaintext")
    return graph


def render_model(model, model_args=None, model_kwargs=None, filename=None,
                 render_distributions=False, render_params=False, *, device=None):
    """Render a model's plate and dependency diagram with graphviz; with
    ``filename`` the diagram is also written there, in the format of its
    suffix (which needs graphviz's ``dot`` program)."""
    relations = get_model_relations(model, model_args=model_args, model_kwargs=model_kwargs,
                                    device=device)
    spec = generate_graph_specification(relations, render_params=render_params)
    graph = render_graph(spec, render_distributions=render_distributions)
    if filename is not None:
        target = Path(filename)
        graph.render(target.with_suffix(""), view=False, cleanup=True, format=target.suffix[1:])
    return graph

"""Contributed modules of the port (``ecs_proxies``, ``enum``,
``control_flow.scan`` and ``control_flow.cond``, the HSGP approximation
``hsgp``, the nested sampler ``nested_sampling`` and DCC/SDVI in
``stochastic_support``; the rest of ``numpyro_tpu/contrib`` is listed in
ROADMAP.md)."""

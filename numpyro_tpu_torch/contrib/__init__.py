"""Contributed modules of the port (``ecs_proxies``, ``enum``,
``control_flow.scan`` and ``control_flow.cond``, the HSGP approximation
``hsgp``, the nested sampler ``nested_sampling``, DCC/SDVI in
``stochastic_support``, SteinVI, SVGD and ASVGD in ``einstein``, and
``module``'s bridge for ``torch.nn`` networks; the rest of
``numpyro_tpu/contrib`` is listed in ROADMAP.md)."""

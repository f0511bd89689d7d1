"""Contributed modules of the port (``ecs_proxies``, ``enum``,
``control_flow.scan`` and ``control_flow.cond``, the HSGP approximation
``hsgp``, the nested sampler ``nested_sampling``, DCC/SDVI in
``stochastic_support`` and SteinVI, SVGD and ASVGD in ``einstein``; the rest
of ``numpyro_tpu/contrib`` is listed in ROADMAP.md)."""

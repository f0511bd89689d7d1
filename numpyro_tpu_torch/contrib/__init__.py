"""Contributed modules of the port (``ecs_proxies``, ``enum`` and
``control_flow.scan``; the rest of ``numpyro_tpu/contrib`` is listed in
ROADMAP.md)."""

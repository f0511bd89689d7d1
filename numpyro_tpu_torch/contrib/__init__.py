"""Contributed modules of the port (``ecs_proxies``, ``enum``,
``control_flow.scan`` and ``control_flow.cond``; the rest of
``numpyro_tpu/contrib`` is listed in ROADMAP.md)."""

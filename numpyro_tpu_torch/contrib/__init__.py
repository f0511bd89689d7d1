"""Contributed modules of the port (``ecs_proxies``; the rest of
``numpyro_tpu/contrib`` is listed in ROADMAP.md)."""

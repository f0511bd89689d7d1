"""Compat utilities (port of ``numpyro_tpu/compat/util.py``)."""


class UnsupportedAPIWarning(Warning):
    pass

"""Example datasets of the port (``examples.datasets``)."""

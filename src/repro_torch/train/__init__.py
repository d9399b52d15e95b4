"""Serving steps of the model zoo: the port of ``repro.train``."""

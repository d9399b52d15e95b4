"""Entry points of the model zoo: the port of ``repro.launch``."""

"""Training and serving steps of the model zoo and their optimizer: the
port of ``repro.train``."""

"""Model zoo (dense and RWKV families): the port of ``repro.models``."""

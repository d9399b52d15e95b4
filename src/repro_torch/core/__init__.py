"""The reference's ``repro.core`` package: one backwards-compatibility
module, ``spritz``."""

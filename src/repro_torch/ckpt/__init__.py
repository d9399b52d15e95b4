"""Checkpoints and the step watchdog: the port of ``repro.ckpt``."""

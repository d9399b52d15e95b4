"""Packet engine: spec types, spec construction, engine."""

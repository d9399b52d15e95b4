"""Topology factories (host side, numpy only)."""

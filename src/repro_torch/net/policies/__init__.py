"""Sender policies (DESIGN.md §11)."""

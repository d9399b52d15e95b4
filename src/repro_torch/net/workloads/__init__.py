"""Traffic generators (host side, numpy only)."""

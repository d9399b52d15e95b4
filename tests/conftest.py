import os
import sys

# Tests run on the single real CPU device (the dry-run, and only the
# dry-run, forces 512 host devices).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def hyp_stubs():
    """(given, settings, st) stand-ins for when ``hypothesis`` is absent
    (optional dev dep, DESIGN.md §7).

    ``given`` marks the decorated test as skipped; ``settings``/``st``
    become inert stubs so module-level strategy expressions and
    ``@settings(...)`` decorators still evaluate.  Non-property tests in
    the same module keep running — only ``@given`` tests skip.
    """
    import pytest

    class _Stub:
        def __call__(self, *a, **k):
            if len(a) == 1 and callable(a[0]) and not k:
                return a[0]  # used as a decorator: pass the function through
            return self

        def __getattr__(self, name):
            return self

    def given(*a, **k):
        return lambda f: pytest.mark.skip(
            reason="hypothesis not installed")(f)

    return given, _Stub(), _Stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (an H100 for the sm_90a "
        "kernels); skips without one")

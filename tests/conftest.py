import inspect
import random
import sys
import types

import jax
import pytest

# Tests run on the single real CPU device (dry-run handles the 512-device
# mesh in its own process; DESIGN.md §6).
jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# hypothesis fallback
# ---------------------------------------------------------------------------
# ``hypothesis`` is a declared test dependency (pyproject [test] extra), but
# the offline container cannot pip-install it.  When it is missing we inject
# a minimal deterministic stand-in — @given runs the property with a fixed
# seeded sample budget — so the property tests still execute instead of
# erroring at collection.  With the real package installed (e.g. in CI) this
# block is inert.

def _build_hypothesis_stub():
    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def floats(min_value, max_value):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def settings(max_examples=20, deadline=None, **_ignored):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    def given(**strats):
        def deco(fn):
            def wrapper(*args, **kwargs):
                rng = random.Random(0xDA7A)
                for _ in range(getattr(wrapper, "_stub_max_examples", 10)):
                    drawn = {k: s.draw(rng) for k, s in strats.items()}
                    fn(*args, **kwargs, **drawn)

            # Hide the drawn params from pytest's fixture resolution, the
            # same way real hypothesis does.
            sig = inspect.signature(fn)
            keep = [p for name, p in sig.parameters.items()
                    if name not in strats]
            wrapper.__signature__ = inspect.Signature(keep)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper._stub_max_examples = getattr(fn, "_stub_max_examples", 10)
            return wrapper
        return deco

    hyp = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.floats = floats
    hyp.strategies = st
    hyp.given = given
    hyp.settings = settings
    return hyp, st


try:
    import hypothesis  # noqa: F401
except ImportError:
    _hyp, _st = _build_hypothesis_stub()
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of the PyTorch port; needs a "
        "GPU and skips without one")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)

"""Shared set-up for the parity tests that run the JAX package as the
reference, and a check of it.

The JAX package uses two names that jax 0.9 moved:

- `jax.core.trace_state_clean` (now `jax._src.core.trace_state_clean`),
  called by every instrumented program (obs/dispatch.py);
- `jax.experimental.enable_x64` (now `jax.enable_x64`), used by the Pallas
  kernels (ops/pallas_kernels.py, ops/pallas_join.py, ops/pallas_gather.py).

`jax_aliases()` installs each alias only when the name is missing and
removes it again on exit, with the dispatch module's cached lookup, so
that no test outside the module that asked for them sees them. A module
asks for them with

    @pytest.fixture(scope="module", autouse=True)
    def _aliases():
        with jax_aliases():
            yield
"""

from contextlib import contextmanager

import spark_rapids_tpu  # noqa: F401  (enables jax x64)
import jax
import jax.experimental


@contextmanager
def jax_aliases():
    from spark_rapids_tpu.obs import dispatch
    added = []
    if not hasattr(jax.core, "trace_state_clean"):
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
        added.append((jax.core, "trace_state_clean"))
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
        added.append((jax.experimental, "enable_x64"))
    original_lookup = dispatch._trace_state_clean
    try:
        yield
    finally:
        for mod, name in added:
            delattr(mod, name)
        dispatch._trace_state_clean = original_lookup
        dispatch.reset_dispatch_ledger()


def test_aliases_are_removed_on_exit():
    before = (hasattr(jax.core, "trace_state_clean"),
              hasattr(jax.experimental, "enable_x64"))
    with jax_aliases():
        assert hasattr(jax.core, "trace_state_clean")
        assert hasattr(jax.experimental, "enable_x64")
    assert (hasattr(jax.core, "trace_state_clean"),
            hasattr(jax.experimental, "enable_x64")) == before

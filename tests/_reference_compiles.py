"""The JAX reference compiled without XLA's optimisations in the port's tests.

The port's tests hold the PyTorch port against ``bodge_tpu`` on small
inputs, where compiling the reference's programs costs far more than running
them, and most of the compile is LLVM's optimisation passes.  The fixture
below, imported into each ``tests/test_torch_*.py`` module, turns those passes
off for the module (``jax_disable_most_optimizations``) and keys the
executables it compiles apart (``jax_optimization_level="O0"``, part of JAX's
jit key), so that no executable compiled here is reused by the reference's
own tests in the same process.  Both settings are restored after the module.
The programs compute the same functions; no tolerance depends on it.  This
module imports JAX only inside the fixture: the row-sharded test's ranks
import their module without JAX.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def unoptimised_reference_compiles():
    import jax

    level = jax.config.jax_optimization_level
    disabled = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_optimization_level", "O0")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_optimization_level", level)
        jax.config.update("jax_disable_most_optimizations", disabled)

"""The port's test plugin that keeps a test process's JAX executables, and
so its memory maps, below the kernel's per-process limit
(``tests/torch_jax_maps.py``): it is registered, it reads the process's maps
and the limit, and a release drops the executables JAX's caches held. The
plugin module is reached through the plugin manager: importing it here
first would keep pytest from registering it as it does for every module."""

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.fixture
def plugin(request):
    return request.config.pluginmanager.get_plugin("tests.torch_jax_maps")


def test_the_plugin_is_registered(plugin):
    assert plugin is not None and hasattr(plugin, "pytest_runtest_teardown")


def test_maps_and_limit_are_read(plugin):
    count, limit = plugin.map_count(), plugin.map_limit()
    assert count is not None and 0 < count < limit


def test_release_drops_the_executables_jax_holds(plugin):
    """Forty held programs hold about three maps each; below the share
    nothing is dropped, at it their executables go."""
    programs = [jax.jit(lambda v, i=i: v * i + 1.0) for i in range(40)]
    for f in programs:
        f(jnp.ones(3)).block_until_ready()
    before = plugin.map_count()
    assert not plugin.release_executables(share=2.0)
    assert plugin.release_executables(share=0.0)
    assert plugin.map_count() <= before - 60
    assert float(programs[0](jnp.ones(3))[0]) == 1.0

"""Shared pytest config. IMPORTANT: do NOT set XLA_FLAGS here — smoke tests
and benches must see the single real CPU device; only launch/dryrun.py forces
512 placeholder devices (in its own process).

Offline-test compat policy: the suite must collect and pass with no network
and no optional deps. `_hypo_compat.install()` registers a fixed-seed
stand-in for `hypothesis` when the real package is absent (real hypothesis
is used untouched when available)."""

import gc

import pytest

import _hypo_compat

_HAVE_REAL_HYPOTHESIS = _hypo_compat.install()

from hypothesis import HealthCheck, settings  # noqa: E402 (after install)

settings.register_profile(
    "repro",
    deadline=None,  # first example pays JIT compile; timings are not the SUT
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc; skips elsewhere")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables_between_modules():
    """Free XLA executables after each test module.

    Every distinct jitted program mmaps its compiled code and stays alive
    for the life of the process; a full-suite run accumulates enough of
    them to exhaust the kernel's vm.max_map_count (65530 by default), at
    which point the NEXT compilation segfaults inside XLA's code
    allocator. Modules rarely share compiled shapes, so clearing between
    modules bounds the map count at roughly one module's worth while
    keeping the (hot) intra-module jit caches intact.
    """
    yield
    import jax

    jax.clear_caches()
    gc.collect()

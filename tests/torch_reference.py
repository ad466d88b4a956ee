"""Pairing of host kernels for the tests that hold the port against the
JAX reference.

Both packages run their setup either on their native C++ host kernels or
on their numpy fallbacks, and the two paths agree only to rounding, which
a 1e-12 parity test can see.  The ``host_kernels`` fixture makes both
packages take the same path in a test: native when both libraries load
(after one retry each), numpy for both otherwise, and records which one
ran in the test's ``user_properties``.  This module imports jax and
``pflare_tpu``, so the card tests (``tests/torch_cases.py``) do not use it.
"""

import fcntl
import os

import pytest

import pflare_tpu.native as jnative
import pflare_tpu_torch.native as tnative

NATIVE, NUMPY = "native", "numpy"
_MODULES = (jnative, tnative)


def _build_both():
    """Build and load both libraries once, one process at a time: the
    reference compiles its library in place, so a worker loading it while
    another writes it would cache a failed load.  The tests do not rely on
    this; ``_loaded`` retries."""
    os.makedirs(tnative.BUILD_DIR, exist_ok=True)
    with open(os.path.join(tnative.BUILD_DIR, "native_build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for mod in _MODULES:
                mod.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_build_both()


def _loaded(mod) -> bool:
    """Whether ``mod``'s library loads, retrying once after a failed or
    cached-failed first load."""
    if mod.get_lib() is None:
        mod._TRIED = False
        mod._LIB = None
    return mod.get_lib() is not None


def pair_host_kernels(monkeypatch, want=NATIVE) -> str:
    """Put both packages on the same host path; returns it.  ``want``
    NUMPY forces the numpy fallbacks; NATIVE takes the native kernels
    when both libraries load, else the numpy fallbacks for both."""
    if want == NATIVE and all(_loaded(mod) for mod in _MODULES):
        return NATIVE
    for mod in _MODULES:
        monkeypatch.setattr(mod, "get_lib", lambda: None)
    return NUMPY


@pytest.fixture
def host_kernels(request, monkeypatch):
    """The host path both packages take in this test (see the module
    docstring); a test parametrised with ``host_kernels`` asks for one."""
    want = getattr(request, "param", NATIVE)
    pairing = pair_host_kernels(monkeypatch, want)
    request.node.user_properties.append(("host_kernels", pairing))
    return pairing

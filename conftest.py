"""Root test config: keep module stubs from leaking between test files.

Some golden tests put bare stand-ins for absent wheels (pyworld, gin,
torchaudio, ...) into ``sys.modules`` so that reference code imports. A
stand-in that outlives its file changes what a later file on the same xdist
worker sees: ``F0Extractor('harvest')`` then takes the pyworld path instead
of the native one. This fixture removes, when a test file is done, every
stand-in that the file added and did not remove itself.
"""
import sys
import types

import pytest


def _is_stub(module) -> bool:
    """A bare ``types.ModuleType`` with no file and no loader: made by hand,
    never by the import system."""
    if type(module) is not types.ModuleType or hasattr(module, "__file__"):
        return False
    spec = getattr(module, "__spec__", None)
    return spec is None or (spec.loader is None and spec.origin is None)


@pytest.fixture(scope="module", autouse=True)
def _drop_leaked_module_stubs():
    before = set(sys.modules)
    yield
    added = [name for name in list(sys.modules) if name not in before]
    stubs = {name for name in added
             if "." not in name and _is_stub(sys.modules[name])}
    for name in added:
        if name.split(".", 1)[0] in stubs and _is_stub(sys.modules[name]):
            del sys.modules[name]

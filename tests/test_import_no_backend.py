"""Importing the library must not initialize a JAX backend.

Regression guard for the module-level-jnp-scalar bug: a ``jnp.float32``
constant at import time creates a device array, which initializes the
default backend (and reserves most of a GPU's memory).  Every compute
module must keep module-level constants as numpy scalars
(``ops/intersect.py::INF``, ``ops/rng.py``) so that
``import logipathtracer_tpu`` and module imports stay backend-free.

Runs in a subprocess: the main pytest process has long since
initialized its CPU backend.
"""

import subprocess
import sys

_CHECK = r"""
import sys
import logipathtracer_tpu  # noqa: F401  (top-level API)
# Pull in every compute module the renderers use.
import logipathtracer_tpu.ops.intersect
import logipathtracer_tpu.ops.rng
import logipathtracer_tpu.ops.bsdf
import logipathtracer_tpu.ops.camera
import logipathtracer_tpu.ops.texture
import logipathtracer_tpu.ops.traverse
import logipathtracer_tpu.ops.traverse_cuda
import logipathtracer_tpu.utils.device
import logipathtracer_tpu.scene.compile
import logipathtracer_tpu.film.image

from jax._src import xla_bridge

if xla_bridge.backends_are_initialized():
    sys.exit("a JAX backend was initialized at import time")
print("no backend initialized")
"""


def test_import_initializes_no_backend():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "no backend initialized" in out.stdout

"""Test env: CPU backend with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), and every render path has a
CPU-runnable form (the reference's 'lavapipe analog', SURVEY.md §4).
Tests marked ``gpu`` need a CUDA device: they run only with
``LPT_GPU_TESTS=1`` on a machine that has one (``pytest -m gpu``), and
skip everywhere else through the ``cuda_device`` fixture.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("LPT_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cornell_glb(tmp_path_factory):
    """The seeded cornell-class scene written as a GLB file."""
    from logipathtracer_tpu.scene.gltf import write_glb
    from logipathtracer_tpu.scene.procedural import make_cornell_scene
    path = tmp_path_factory.mktemp("scenes") / "cornell.glb"
    return write_glb(make_cornell_scene(), str(path))


@pytest.fixture(scope="session")
def cornell_gltf(cornell_glb):
    """The cornell-class scene as the loader reads it back."""
    from logipathtracer_tpu.scene.gltf import load_gltf
    return load_gltf(cornell_glb)


@pytest.fixture(scope="session")
def cornell_scene(cornell_gltf):
    from logipathtracer_tpu.scene.compile import compile_scene
    return compile_scene(cornell_gltf)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where JAX has none."""
    from logipathtracer_tpu.ops.traverse_cuda import cuda_available
    if not cuda_available():
        pytest.skip("needs a CUDA device (LPT_GPU_TESTS=1 on a GPU host)")
    return jax.devices("cuda")[0]


@pytest.fixture
def no_cuda_device():
    """Skips a test of CPU-host behaviour where a CUDA device exists."""
    from logipathtracer_tpu.ops.traverse_cuda import cuda_available
    if cuda_available():
        pytest.skip("checks behaviour without a CUDA device")


@pytest.fixture
def mesh_devices():
    """Eight devices for the sharding tests; skips with fewer."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip(f"needs 8 devices, have {len(devs)}")
    return devs[:8]


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Free compiled executables between test modules.

    XLA:CPU has been seen to crash once a single process accumulates
    enough compiled code; dropping the jit caches per module bounds the
    resident compiled-code volume.  Cross-module graph reuse is near
    zero (graphs are file-specific), so the cost is seconds.
    """
    yield
    jax.clear_caches()

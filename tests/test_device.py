"""Where a run reports it ran, and where it keeps its compile cache
(utils/device.py, utils/cache.py)."""

import jax
import pytest

from logipathtracer_tpu.utils import cache, device


def test_device_record_names_the_platform(no_cuda_device):
    rec = device.device_record(jax)
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_require_gpu_raises_on_cpu(no_cuda_device):
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu(jax)


def test_run_context_fields(no_cuda_device, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/nowhere")
    monkeypatch.setattr(device, "gpu_name_and_power_limit", lambda: None)
    ctx = device.run_context(jax)
    assert ctx["device"]["platform"] == "cpu"
    assert ctx["gpu"] is None
    assert ctx["xla_flags"] == "--xla_dump_to=/nowhere"


@pytest.mark.parametrize("stdout,rc,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n", 0,
     "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("", 9, None)])
def test_gpu_name_and_power_limit(monkeypatch, stdout, rc, want):
    class Done:
        returncode = rc

    Done.stdout = stdout
    monkeypatch.setattr(device.subprocess, "run", lambda *a, **k: Done())
    assert device.gpu_name_and_power_limit() == want


def test_gpu_name_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(device.subprocess, "run", missing)
    assert device.gpu_name_and_power_limit() is None


class _FakeJax:
    """The slice of the jax module configure_compile_cache touches."""

    def __init__(self, backend):
        self.backend = backend
        self.updates = {}
        self.config = self

    def default_backend(self):
        return self.backend

    def update(self, key, value):
        self.updates[key] = value


@pytest.mark.parametrize("backend,env,want_dir", [
    ("gpu", None, cache.REPO_CACHE),
    ("gpu", "/elsewhere/cache", None),
    ("cpu", None, None),
    ("cpu", "/elsewhere/cache", None)])
def test_compile_cache_location(monkeypatch, backend, env, want_dir):
    """The environment's cache directory wins and is never overridden;
    otherwise accelerator runs use the one fixed path in the checkout
    and CPU runs use none."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    fake = _FakeJax(backend)
    used = cache.configure_compile_cache(fake)
    assert used == (env or want_dir)
    assert fake.updates.get("jax_compilation_cache_dir") == want_dir
    assert cache.REPO_CACHE.endswith("tests/.jax_cache")

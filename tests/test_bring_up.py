"""Start-up plumbing around the card: the compile-cache location, the
device check that refuses to measure without a GPU, and the reading of
``nvidia-smi``'s card line."""
import importlib.util
import os

import jax
import pytest

from localregneuralde_tpu.utils import compile_cache
from localregneuralde_tpu.utils.device import (
    device_record,
    parse_gpu_query,
    require_gpu,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_sets_a_dir_only_when_unset(
        monkeypatch, tmp_path, env_set):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("text,cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n"
     "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 PCIe, [N/A]\n", [("NVIDIA H100 PCIe", "[N/A]")]),
])
def test_parse_gpu_query(text, cards):
    assert parse_gpu_query(text) == cards


@pytest.mark.parametrize("text", ["NVIDIA H100 80GB HBM3\n", ", 700.00 W"])
def test_parse_gpu_query_rejects_other_output(text):
    with pytest.raises(ValueError):
        parse_gpu_query(text)


def test_require_gpu_refuses_the_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_device_record_names_platform_kind_count():
    rec = device_record(jax.devices())
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("count", [1, 4])
def test_chip_smoke_device_phase_refuses_the_cpu(capsys, count):
    smoke = _chip_smoke()
    with pytest.raises(RuntimeError, match="no GPU"):
        smoke.device_phase(count=count)
    # nothing that looks like a result reaches standard output
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_exits_nonzero_without_gpu_or_package(tmp_path, where):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the script fails and prints no result line."""
    import shutil
    import subprocess
    import sys

    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

"""Entry points that need the GPU refuse the CPU; compile-cache placement;
the smoke run's capture and INI writer."""
import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    import gnsslib_tpu
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert gnsslib_tpu.cache_dir() is None


def test_cache_dir_fixed_inside_checkout(monkeypatch):
    import gnsslib_tpu
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = gnsslib_tpu.cache_dir()
    assert d == gnsslib_tpu.cache_dir()                 # stable path
    assert os.path.dirname(d) == os.path.join(ROOT, ".jax_cache")
    assert not d.startswith(os.path.expanduser("~") + os.sep + ".")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_set_at_import_when_env_set(tmp_path):
    """With the variable set, JAX's own setting stands (no other
    directory is set in code)."""
    code = ("import jax, gnsslib_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(_cpu_env(), JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_capture_and_ini(tmp_path, monkeypatch):
    """The smoke run's writers at tiny size: the capture holds the
    requested int8 samples and load_ini reads the INI back as the
    32-channel iffile.ini receiver."""
    monkeypatch.syspath_prepend(ROOT)
    cs = importlib.import_module("chip_smoke")
    from gnsslib_tpu import sim
    from gnsslib_tpu.runtime.config import load_ini
    cap = str(tmp_path / "cap.bin")
    sim.write_demo_capture(cap, 0.003, cs.F_SF, cs.F_IF,
                           npresent=cs.NPRESENT, workers=1)
    x = np.fromfile(cap, np.int8)
    assert x.size == int(0.003 * cs.F_SF)
    assert x.std() > 1.0                         # noise + signals, not zeros
    ini = cs.write_ini(str(tmp_path), cap, str(tmp_path / "rinex"))
    cfg = load_ini(ini)
    assert [c.prn for c in cfg.channels] == list(range(1, 33))
    assert cfg.fends[0].f_sf == cs.F_SF and cfg.fends[0].f_if == cs.F_IF
    assert cfg.files == [cap]
    assert (cfg.track.corrn, cfg.track.corrd, cfg.track.corrp) == (6, 3, 6)
    assert cfg.track.ntaps == 13
    assert cfg.outms == 400 and cfg.rinex


def test_bench_refuses_cpu():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


def test_require_gpu_reports_platform():
    from gnsslib_tpu.runtime.device import require_gpu
    with pytest.raises(RuntimeError, match="'cpu'"):
        require_gpu()

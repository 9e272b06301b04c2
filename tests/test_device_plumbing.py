"""Device plumbing: the compile-cache directory, the device identity in
-metrics.json, and chip_smoke.py's refusal to run anywhere but a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax
    from ahsoka_tpu.utils import xla_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert xla_cache.compilation_cache_dir() == str(tmp_path)
    assert xla_cache.enable_persistent_compilation_cache() == str(tmp_path)
    # jax reads the variable itself: the program sets no directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    import jax
    from ahsoka_tpu.utils import xla_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert xla_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert xla_cache.compilation_cache_dir() == xla_cache.DEFAULT_DIR
    assert xla_cache.enable_persistent_compilation_cache() \
        == xla_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == xla_cache.DEFAULT_DIR
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("backend", ["jax", "host"])
def test_metrics_name_the_device(backend, tmp_path):
    import jax
    from ahsoka_tpu.cli.main import main

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    out = str(tmp_path / "o")
    assert main(["phase", "-g", os.path.join(DATA, "golden_diploid.gfa"),
                 "-a", str(gaf), "-o", out, "--backend", backend]) == 0
    m = json.load(open(out + "-metrics.json"))
    if backend == "jax":
        dev = jax.devices()[0]
        assert m["platform"] == dev.platform
        assert m["device_kind"] == dev.device_kind
        assert m["device_count"] == len(jax.devices())
        assert m["local_device_ids"] == [d.id for d in jax.local_devices()]
    else:
        assert m["platform"] is None and m["device_count"] == 0
        assert m["local_device_ids"] == []


def test_cli_no_debug_readsets_flag(tmp_path):
    from ahsoka_tpu.cli.main import main

    gaf = tmp_path / "golden_diploid.gaf"
    shutil.copy(os.path.join(DATA, "golden_diploid.gaf"), gaf)
    for tag, extra in (("a", []), ("b", ["--no-debug-readsets"])):
        assert main(["phase", "-g", os.path.join(DATA, "golden_diploid.gfa"),
                     "-a", str(gaf), "-o", str(tmp_path / tag)]
                    + extra) == 0
    assert list(tmp_path.glob("a-chain*-readset.txt"))
    assert not list(tmp_path.glob("b-chain*-readset.txt"))
    assert (tmp_path / "a-result.txt").read_bytes() == \
        (tmp_path / "b-result.txt").read_bytes()


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "this smoke runs on a GPU only" in out.stdout


def test_chip_smoke_refuses_without_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_result_line():
    sys.path.insert(0, REPO)
    import chip_smoke

    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


@pytest.mark.parametrize("stage,module,name", [
    ("projection", "ahsoka_tpu.project.device",
     "containment_key_tables_many"),
    ("scoring", "ahsoka_tpu.score.device", "score_pairs_device_many"),
    ("threading", "ahsoka_tpu.thread.dp_jax", "thread_chains_batched"),
])
def test_chip_smoke_fails_on_batched_stage_error(stage, module, name,
                                                 monkeypatch, tmp_path):
    """The smoke's CLI runs (no --keep-going) fail when a batched device
    stage raises: no per-chain fallback hides it."""
    import importlib

    from ahsoka_tpu.utils.synth import SynthSpec, write_synthetic
    sys.path.insert(0, REPO)
    import chip_smoke

    gfa, gaf = str(tmp_path / "s.gfa"), str(tmp_path / "s.gaf")
    write_synthetic(gfa, gaf, SynthSpec(
        num_chains=3, bubbles_per_chain=12, reads_per_hap=20, span=3,
        error_rate=0.02, seed=5))
    argv = chip_smoke.cli_argv(gfa, gaf, str(tmp_path / "ok"))
    assert "--keep-going" not in argv
    chip_smoke.run_cli(argv)               # the run is fine unpatched

    def boom(*a, **k):
        raise RuntimeError(f"synthetic {stage} failure")

    monkeypatch.setattr(importlib.import_module(module), name, boom)
    with pytest.raises(RuntimeError, match=f"synthetic {stage}"):
        chip_smoke.run_cli(chip_smoke.cli_argv(gfa, gaf,
                                               str(tmp_path / "bad")))

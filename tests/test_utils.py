"""Observability + restartable-run utilities."""
import json

import numpy as np
import pytest
import jax.numpy as jnp

from ife_tpu.parallel.launcher import ShardManifest, distributed_init
from ife_tpu.utils.logging import get_logger, log_json
from ife_tpu.utils.profiling import StageMetrics, stage_timer


def test_stage_timer_records_and_emits(capsys):
    m = StageMetrics()
    with stage_timer("smooth", voxels=1000, metrics=m, emit=True):
        jnp.ones(16).sum().block_until_ready()
    s = m.summary()
    assert "smooth" in s and s["smooth"]["calls"] == 1
    assert s["smooth"]["seconds"] > 0
    line = capsys.readouterr().err.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["event"] == "stage" and rec["stage"] == "smooth"
    assert rec["voxels_per_sec"] > 0


def test_log_json_shape(capsys):
    log_json("bench", {"value": 1.5})
    rec = json.loads(capsys.readouterr().err.strip())
    assert rec["event"] == "bench" and rec["value"] == 1.5 and "t" in rec


def test_logger_singleton_no_duplicate_handlers():
    a = get_logger("ife.x")
    b = get_logger("ife.x")
    assert a is b and len(a.handlers) == 1


def test_distributed_init_single_process_default(monkeypatch):
    monkeypatch.delenv("IFE_COORDINATOR", raising=False)
    assert distributed_init() == (0, 1)


def test_shard_manifest_restart_cycle(tmp_path):
    man = ShardManifest(str(tmp_path / "run.manifest.json"))
    keys = [f"block_{i}" for i in range(4)]
    assert man.pending(keys) == keys
    out = tmp_path / "block_1.npy"
    np.save(out, np.zeros(3))
    man.mark_done("block_1", str(out))
    man.mark_done("block_3")  # no output file
    assert man.pending(keys) == ["block_0", "block_2"]
    # a manifest entry whose output file vanished is NOT done
    out.unlink()
    assert man.pending(keys) == ["block_0", "block_1", "block_2"]
    man.reset()
    assert man.pending(keys) == keys


def test_resample_2d_bspline_order3():
    # reference ExtractWindow.cxx:112-161: B-spline order 3 + ceil sizing.
    # A cubic polynomial surface is reproduced EXACTLY by cubic B-spline
    # interpolation in the interior (up to prefilter roundoff) but not by
    # bilinear — that distinguishes the orders.
    import numpy as np
    import jax.numpy as jnp
    from ife_tpu.ops.transform import resample_to_spacing_2d

    n = 33
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    img = (0.02 * i ** 3 - 0.5 * i * i + 3 * i
           + 0.01 * j ** 3 + 0.2 * j * j - j).astype(np.float32)
    spacing = (0.7, 0.7)
    out_sp = 0.25
    got3 = np.asarray(resample_to_spacing_2d(jnp.asarray(img), spacing,
                                             out_sp, order=3))
    got1 = np.asarray(resample_to_spacing_2d(jnp.asarray(img), spacing,
                                             out_sp, order=1))
    # ceil sizing (reference :119-122)
    assert got3.shape == (int(np.ceil(n * 0.7 / 0.25)),) * 2
    ii = np.arange(got3.shape[0]) * out_sp / spacing[0]
    jj = np.arange(got3.shape[1]) * out_sp / spacing[1]
    I, J = np.meshgrid(ii, jj, indexing="ij")
    want = 0.02 * I ** 3 - 0.5 * I * I + 3 * I + 0.01 * J ** 3 + 0.2 * J * J - J
    # interior margin 8: the spline prefilter's boundary influence decays
    # as |sqrt(3)-2|^d; at d=8 it is ~2e-4 of the boundary magnitude here
    interior = (I > 8) & (I < n - 9) & (J > 8) & (J < n - 9)
    e3 = np.abs(got3 - want)[interior].max()
    e1 = np.abs(got1 - want)[interior].max()
    assert e3 < 1e-3, e3            # cubic: exact up to boundary decay
    assert e3 < e1 / 100, (e3, e1)  # far below bilinear's O(h^2) error
    # order=0 is exact nearest-neighbor (mask path, reference :230-232)
    got0 = np.asarray(resample_to_spacing_2d(jnp.asarray(img), spacing,
                                             out_sp, order=0))
    src = img[np.round(I).clip(0, n - 1).astype(int),
              np.round(J).clip(0, n - 1).astype(int)]
    np.testing.assert_array_equal(got0, src)


# --- persistent compilation cache location ---------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from ife_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    import os

    import jax

    from ife_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == compile_cache.REPO_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_main_sets_up_compile_cache(monkeypatch):
    from ife_tpu.cli.main import main as cli
    from ife_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    with pytest.raises(SystemExit):
        cli(["extract-features", "--help"])
    assert calls == []  # --help exits before any device work
    cli(["convert-hr2", "/nonexistent.hr2", "/nonexistent.nii"])
    assert calls == [1]


def test_tests_write_no_compile_cache():
    import jax

    assert jax.config.jax_enable_compilation_cache is False

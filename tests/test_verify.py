"""The CPU-checkable parts of the on-device verification (gpu_verify.py)
and of the smoke run that uses it (chip_smoke.py): the comparison rules,
the nvidia-smi parsing, the device check, the result line, and that the
smoke run fails — with no result line — where there is no GPU."""
import json
import os
import shutil
import stat
import subprocess
import sys

import numpy as np
import pytest

import gpu_verify as V

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- comparison rules -------------------------------------------------------

def _features(seed=0, shape=(6, 5, 4)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (8,)) * 100.0


def test_feature_errors_within_budget_pass():
    want = _features()
    got = want * (1 + 1e-6)
    errs = V.feature_errors(got, want)
    assert set(errs) == {f"c{c}" for c in range(8)} | {"eig_sorted"}
    assert V.check_within("ok", errs) <= 1e-6 * 1.01


def test_feature_errors_over_budget_fail():
    want = _features()
    got = want.copy()
    got[..., 6] += 1e-2 * np.abs(want[..., 6]).max()   # curvature channel
    with pytest.raises(V.VerifyError, match="c6"):
        V.check_within("bad", V.feature_errors(got, want))


def test_eigen_channels_compare_as_sorted_triples():
    """Swapping two eigen channels (a near-tie reorder) is no error; a
    wrong eigenvalue is."""
    want = _features(1)
    got = want.copy()
    got[..., [2, 3]] = want[..., [3, 2]]
    errs = V.feature_errors(got, want)
    assert errs["eig_sorted"] == 0.0
    assert errs["c2"] > V.BUDGET          # reported, not budgeted
    V.check_within("swap", errs)
    got[..., 4] += 1.0 + np.abs(want[..., 2:5]).max()
    with pytest.raises(V.VerifyError, match="eig_sorted"):
        V.check_within("wrong", V.feature_errors(got, want))


def test_nonfinite_error_fails():
    want = _features(2)
    got = want.copy()
    got[0, 0, 0, 0] = np.nan
    with pytest.raises(V.VerifyError):
        V.check_within("nan", V.feature_errors(got, want))


def test_channel_scale_floor_is_one():
    """Errors are relative to max(|ref|, 1): a channel of tiny values
    is judged in absolute terms."""
    want = np.zeros((3, 3, 3, 8))
    got = want + 5e-5
    assert V.feature_errors(got, want)["c0"] == pytest.approx(5e-5)


def test_eigen_feature_errors_keys_and_sorting():
    rng = np.random.default_rng(3)
    want = rng.standard_normal((5, 4, 3, 6))
    got = want.copy()
    got[..., [0, 1]] = want[..., [1, 0]]
    errs = V.eigen_feature_errors(got, want)
    assert set(errs) == {"sum", "prod", "frob", "eig_sorted"}
    assert V.check_within("eig", errs) == 0.0


def test_shape_mismatch_fails():
    with pytest.raises(V.VerifyError):
        V.feature_errors(np.zeros((2, 2, 2, 8)), np.zeros((2, 2, 3, 8)))


def test_histogram_counts_must_be_exact():
    edges = np.array([-1.0, 0.0, 0.5], np.float32)
    vals = np.array([-2, -1, -0.5, 0, 0.25, 0.5, 3], np.float32)
    want = V.searchsorted_counts(vals, edges)
    np.testing.assert_array_equal(want, [2, 2, 2, 1])
    assert V.count_mismatch(want, want) == 0
    assert V.count_mismatch(want + np.array([0, 1, 0, 0]), want) == 1
    w = np.array([1, 0, 1, 1, 1, 0, 1])
    np.testing.assert_array_equal(V.searchsorted_counts(vals, edges, w),
                                  [1, 2, 1, 1])


# --- the CT-like precision table ---------------------------------------------

def _features_with(monkeypatch, perturb=None):
    """Make the table's features8_auto the f64 path (errors at roundoff,
    whatever the host CPU), optionally perturbed."""
    import jax.numpy as jnp

    from ife_tpu.ops import features

    plain = features.features8_auto

    def f64(img, msk, sigma, spacing):
        out = plain(jnp.asarray(img, jnp.float64), msk, sigma, spacing)
        return out if perturb is None else perturb(out, sigma)

    monkeypatch.setattr(features, "features8_auto", f64)


def test_ct_precision_table_logs_and_checks_every_scale(monkeypatch):
    _features_with(monkeypatch)
    lines = []
    table = V.ct_precision_table((32, 30, 27), log=lines.append)
    assert sorted(table) == sorted(V.SCALES)
    assert len(lines) == len(V.SCALES)
    for line, s in zip(lines, V.SCALES):
        assert f"s={s}:" in line and "eigenvalues (sorted)" in line
    assert max(V.check_within("t", e) for e in table.values()) < 1e-9


def test_ct_precision_table_fails_over_budget_after_logging(monkeypatch):
    """One scale over the budget fails the table, but only after every
    scale's reading is logged."""
    def bad_curvature_at_largest(out, sigma):
        if sigma != max(V.SCALES):
            return out
        return out.at[..., 6].add(1e-2 * (abs(out[..., 6]).max() + 1.0))

    _features_with(monkeypatch, bad_curvature_at_largest)
    lines = []
    with pytest.raises(V.VerifyError, match="c6"):
        V.ct_precision_table((32, 30, 27), log=lines.append)
    assert len(lines) == len(V.SCALES)


# --- the native library ------------------------------------------------------

@pytest.mark.parametrize("make_rc,loads,match", [
    (2, True, "build failed"),
    (0, False, "did not load"),
])
def test_smoke_native_build_failure_raises(monkeypatch, make_rc, loads,
                                          match):
    """A broken native build fails the smoke run instead of leaving it on
    the pure-Python host fallbacks."""
    import chip_smoke
    from ife_tpu import native_lib

    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(
                            a, make_rc, "", "error: no compiler"))
    monkeypatch.setattr(native_lib, "lib",
                        lambda: object() if loads else None)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.build_native()


# --- nvidia-smi, the device and the result line ------------------------------

@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
])
def test_parse_nvidia_smi(text, want):
    assert V.parse_nvidia_smi(text) == want


@pytest.mark.parametrize("text", [
    "", "\n", "NVIDIA H100 80GB HBM3\n", "a, b, c\n",
    "NVIDIA-SMI has failed because it couldn't communicate with the driver",
])
def test_parse_nvidia_smi_rejects(text):
    with pytest.raises(ValueError):
        V.parse_nvidia_smi(text)


class _Dev:
    def __init__(self, platform, kind="NVIDIA H100 80GB HBM3"):
        self.platform = platform
        self.device_kind = kind


def test_require_gpu_raises_off_gpu():
    import jax

    with pytest.raises(RuntimeError, match="needs a GPU"):
        V.require_gpu(jax.devices())          # this sandbox: cpu
    with pytest.raises(RuntimeError):
        V.require_gpu([_Dev("gpu"), _Dev("cpu")])
    with pytest.raises(RuntimeError):
        V.require_gpu([])
    devs = [_Dev("gpu")]
    assert V.require_gpu(devs) is devs


def test_result_line_shape():
    line = V.result_line([_Dev("gpu")] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


# --- the smoke run where there is no GPU -------------------------------------

def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_failed_without_result(r):
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last, r.stdout


def test_smoke_fails_without_nvidia_smi(tmp_path):
    r = _run_smoke(REPO, {"PATH": str(tmp_path)})
    _assert_failed_without_result(r)
    assert "nvidia-smi" in r.stderr


def test_smoke_fails_when_jax_finds_no_gpu(tmp_path):
    """A readable nvidia-smi but no CUDA backend: the CUDA pin must raise
    instead of falling back to the CPU."""
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    r = _run_smoke(REPO, {"PATH": f"{tmp_path}{os.pathsep}"
                                  f"{os.environ.get('PATH', '')}",
                          "JAX_PLATFORMS": ""})
    _assert_failed_without_result(r)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in r.stdout


def test_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), {"PYTHONPATH": ""})
    _assert_failed_without_result(r)


def test_bench_raises_off_gpu(tmp_path):
    env = dict(os.environ)
    env["PATH"] = str(tmp_path)
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""

"""True multi-process distributed runs: 2 JAX processes (gloo CPU
collectives, 2 virtual devices each -> a 4-device global mesh) driving the
REAL product surface — `ife ... --sharded --coordinator ...` subprocesses.

This is the CPU-simulated multi-host pattern (SURVEY.md §4): the reference
is strictly single-process, so the oracle is the single-process run of the
same command. Restartability (ShardManifest) is asserted by re-running the
same distributed command and observing completed blocks being skipped.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ife_tpu.core.volume import synthetic_ct, sphere_mask
from ife_tpu.io import read_volume, write_volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    env.pop("JAX_ENABLE_X64", None)  # product dtype is f32, like the CLI
    env.update(extra or {})
    return env


def _run_cli(args, extra_env=None, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "ife_tpu", *[str(a) for a in args]],
        env=_env(extra_env), capture_output=True, text=True, timeout=timeout,
    )


def _run_distributed(args, nprocs=2, timeout=240):
    """Launch the same `ife` command in `nprocs` coordinated processes.
    Returns the completed process objects, primary first."""
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ife_tpu", *[str(a) for a in args],
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(nprocs), "--process-id", str(pid)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append((p.returncode, out))
    return outs


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    vol = synthetic_ct((24, 20, 16), seed=3)
    mask = sphere_mask((24, 20, 16), 0.45)
    write_volume(str(d / "img.nii.gz"), vol)
    write_volume(str(d / "mask.nii.gz"), mask)
    return d


@pytest.mark.slow
def test_two_process_extract_features_matches_single(workdir):
    d = workdir
    base = ["extract-features", "-i", d / "img.nii.gz",
            "-m", d / "mask.nii.gz", "-s", "1.0"]
    r = _run_cli([*base, "-o", d / "single"])
    assert r.returncode == 0, r.stdout + r.stderr

    outs = _run_distributed(
        [*base, "-o", d / "mp", "--sharded",
         "--manifest", d / "mp.manifest.json"])
    for rc, out in outs:
        assert rc == 0, out
    from ife_tpu.ops.features import FEATURE_NAMES

    for name in FEATURE_NAMES:
        a = read_volume(str(d / f"single_scale_1{name}.nii.gz")).data
        b = read_volume(str(d / f"mp_scale_1{name}.nii.gz")).data
        scale = max(np.abs(a).max(), 1.0)
        # f32 CLI product dtype: the sharded path's blocked contractions
        # sum in a different order than the whole-volume pass; eigen
        # channels amplify that by ~|H|/gap (observed ~1e-5 rel)
        assert np.abs(a - b).max() / scale < 5e-5, name

    # restart: the manifest marks scale 1 complete -> both processes skip
    outs = _run_distributed(
        [*base, "-o", d / "mp", "--sharded",
         "--manifest", d / "mp.manifest.json"])
    for rc, out in outs:
        assert rc == 0, out
        assert "Skipping completed scale" in out


@pytest.mark.slow
def test_two_process_determine_bin_edges_sharded(workdir):
    d = workdir
    with open(d / "pairs.txt", "w") as f:
        f.write(f"{d/'img.nii.gz'},{d/'mask.nii.gz'}\n")
    base = ["determine-bin-edges", "-l", d / "pairs.txt", "-s", "1.0",
            "--bins", "4"]
    # single-process sharded run (same histogram-CDF algorithm) = oracle
    r = _run_cli([*base, "-o", d / "edges_1p.txt", "--sharded"])
    assert r.returncode == 0, r.stdout + r.stderr

    outs = _run_distributed([*base, "-o", d / "edges_2p.txt", "--sharded"])
    for rc, out in outs:
        assert rc == 0, out

    def read_spec(p):
        rows = []
        with open(p) as f:
            for line in f:
                if line.strip() and not line.startswith("#"):
                    rows.append([float(v) for v in line.split(",")])
        return np.asarray(rows)

    a, b = read_spec(d / "edges_1p.txt"), read_spec(d / "edges_2p.txt")
    assert a.shape == b.shape == (8, 3)  # 8 features x (bins-1) edges
    # the 2-process mesh shards the volume differently, but the psum'd
    # histogram and merged CDF must be device-layout independent
    assert np.allclose(a, b, rtol=1e-5, atol=1e-6)

#!/usr/bin/env python3
"""Smoke run of the feature pipeline on an NVIDIA GPU.

    python chip_smoke.py               # one card: verify + CLI pipeline
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card, in order:
  1. read `nvidia-smi --query-gpu=name,power.limit` in a child process
     (before JAX touches the card) and print it; fail if it cannot;
  2. pin JAX to CUDA — no CPU fallback — and print the devices;
  3. rebuild the native host library from source and say if it loaded;
  4. verify: every dispatched entry point on the card against the f64
     reference (tests/numpy_ref.py), at the unaligned (128, 124, 120)
     scan and at full width 512x512x509; budgets in gpu_verify.py
     (1e-4 of channel scale; eigen channels as sorted triples;
     histograms integer-exact); plus the per-channel f32-vs-f64 table of
     the CT-like scan at every scale, held to the same budget;
  5. the pipeline through the `ife` CLI in this one process, on a
     512x512x509 lung-CT-like scan at 0.78x0.78x1.0 mm written as
     .nii.gz: extract-features, determine-bin-edges (sigma 0.6, 1.2, 2.4,
     4.8), generate-rois (50 of 41^3), make-bag on the host and on the
     device, the two bags within 1e-6.
With --four-cards: sharded_features8 and sharded_masked_histogram on a
2x2 mesh of four cards, and `determine-bin-edges --sharded`, each
compared with the same work on one card.

Every phase prints its wall time. Any failure raises (non-zero exit, no
result line). The last line of stdout is the JSON result
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the script's directory is sys.path[0], so these are the checkout's own
# modules; alone, without the checkout, the import fails
import gpu_verify as V
from gpu_verify import SCALES, SPACING

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = (512, 512, 509)      # a clinical depth that is not a multiple of 8
N_ROIS, ROI_SIZE = 50, 41
BINS, SAMPLES = 41, 500_000  # the reference's bin count; bin-edge samples
FOUR_CARD_SCALES = (0.6, 4.8)
FINE_BINS = 4096


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def build_native() -> None:
    """Rebuild native/libife_native.so from the committed source (never
    reuse a library built for another CPU) and load it; raises if either
    fails, so the run covers the host path users run."""
    r = subprocess.run(["make", "-C", os.path.join(HERE, "native"), "-B"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native library build failed:\n"
                           f"{(r.stderr or r.stdout).strip()}")
    from ife_tpu import native_lib

    if native_lib.lib() is None:
        raise RuntimeError("native library rebuilt but did not load")
    print("native library: rebuilt, loaded")


def ife(*argv) -> None:
    """One `ife` CLI command, in this process; raises on failure."""
    from ife_tpu.cli.main import main

    argv = [str(a) for a in argv]
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"ife {' '.join(argv)} exited {rc}")


def write_scan(workdir: str, seed: int):
    """The CT-like scan and lung mask as .nii.gz; returns their paths and
    the host arrays."""
    from ife_tpu.core.volume import Volume
    from ife_tpu.io import write_volume

    img, msk = V.scan(SHAPE, seed)
    paths = (os.path.join(workdir, "ct.nii.gz"),
             os.path.join(workdir, "lungs.nii.gz"))
    write_volume(paths[0], Volume(img, spacing=SPACING))
    write_volume(paths[1], Volume(msk, spacing=SPACING))
    return paths, img, msk


def read_spec(path) -> np.ndarray:
    from ife_tpu.io import read_hist_spec

    return np.asarray(read_hist_spec(path), np.float64)


def print_memory_analysis(img, msk, sigma: float) -> None:
    """XLA's memory analysis of the compiled features step."""
    from ife_tpu.ops.features import features8_channels_jit

    ma = features8_channels_jit.lower(
        img, msk, sigma=sigma, spacing=SPACING, truncate=4.5
    ).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    print(f"features step {img.shape} s={sigma} memory_analysis: "
          + ", ".join(f"{f}={getattr(ma, f, None)}" for f in fields))


def pipeline_phase(workdir: str, seed: int) -> None:
    """The reference tool chain through the CLI, on one scan."""
    import jax.numpy as jnp

    from ife_tpu.io import read_volume
    from ife_tpu.io.text import read_text_matrix
    from ife_tpu.ops.features import FEATURE_NAMES

    with phase(f"write scan {SHAPE} as .nii.gz"):
        (img_p, msk_p), img, msk = write_scan(workdir, seed)
    print_memory_analysis(jnp.asarray(img), jnp.asarray(msk), 1.2)

    out = os.path.join(workdir, "feat")
    with phase("ife extract-features (s=1.2, 8 .nii.gz outputs)"):
        ife("extract-features", "-i", img_p, "-m", msk_p, "-o", out,
            "-s", "1.2")
    for name in FEATURE_NAMES:
        f = read_volume(f"{out}_scale_1.2{name}.nii.gz").numpy()
        if f.shape != SHAPE or not np.all(np.isfinite(f)):
            raise RuntimeError(f"extract-features {name}: bad output")
        if np.any(f[msk == 0] != 0):
            raise RuntimeError(f"extract-features {name}: nonzero outside")

    pairs = os.path.join(workdir, "pairs.txt")
    with open(pairs, "w") as fh:
        fh.write(f"{img_p},{msk_p}\n")
    spec = os.path.join(workdir, "spec.txt")
    scales = [str(s) for s in SCALES]
    with phase(f"ife determine-bin-edges ({len(SCALES)} scales, "
               f"{BINS} bins)"):
        ife("determine-bin-edges", "-l", pairs, "-o", spec, "-s", *scales,
            "--bins", BINS, "--samples", SAMPLES, "--foreground", 1, 2,
            "--seed", seed)
    edges = read_spec(spec)
    if edges.shape != (8 * len(SCALES), BINS - 1) or not np.all(
            np.diff(edges, axis=1) >= 0):
        raise RuntimeError(f"bin-edge spec has shape {edges.shape}")

    rois = os.path.join(workdir, "rois.ROIInfo")
    with phase(f"ife generate-rois ({N_ROIS} of {ROI_SIZE}^3)"):
        ife("generate-rois", "-m", msk_p, "-o", rois, "-n", N_ROIS,
            "--size", f"{ROI_SIZE},{ROI_SIZE},{ROI_SIZE}", "--seed", seed)

    bags = {}
    for tag, extra in (("host", ()), ("device", ("--device",))):
        prefix = os.path.join(workdir, f"bag_{tag}")
        with phase(f"ife make-bag ({tag}, {len(SCALES)} scales)"):
            ife("make-bag", "-i", img_p, "-m", msk_p, "-b", spec, "-r", rois,
                "-o", prefix, "-s", *scales, *extra)
        bags[tag] = np.asarray(read_text_matrix(f"{prefix}.bag"), np.float64)
    host, dev = bags["host"], bags["device"]
    want = (N_ROIS, 8 * len(SCALES) * BINS)
    if host.shape != want or dev.shape != want:
        raise RuntimeError(f"bag shapes {host.shape} {dev.shape} != {want}")
    sums = host.reshape(N_ROIS, 8 * len(SCALES), BINS).sum(-1)
    if not np.allclose(sums, 1.0, atol=1e-9):
        raise RuntimeError("bag rows are not frequency histograms")
    diff = float(np.abs(host - dev).max())
    print(f"make-bag host vs device: max abs diff {diff:.3e} (budget 1e-6)")
    if not diff <= 1e-6:
        raise RuntimeError(f"device bag differs from host bag by {diff}")


def four_cards_phase(devices, workdir: str, seed: int) -> None:
    """The sharded path on a 2x2 mesh of four devices, each result
    compared with the same work on one device."""
    import jax
    import jax.numpy as jnp

    from ife_tpu.ops.features import NUM_FEATURES, features8_auto_channels
    from ife_tpu.parallel import (
        make_mesh, merge_fine_histograms, shard_volume,
        sharded_feature_fine_histograms, sharded_features8,
        sharded_masked_histogram,
    )
    from ife_tpu.stats.equalize import edges_from_dense_counts
    from ife_tpu.stats.histogram import histogram_counts

    mesh = make_mesh(4, ("x", "y"), devices=devices[:4])
    one = devices[0]
    print(f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))} over "
          f"{[d.id for d in mesh.devices.ravel()]}")
    with phase(f"write scan {SHAPE} as .nii.gz"):
        (img_p, msk_p), img, msk = write_scan(workdir, seed)

    img_s = shard_volume(jnp.asarray(img), mesh)
    msk_s = shard_volume(jnp.asarray(msk), mesh)
    blocks = {s.device.id: (s.data.shape, s.index)
              for s in img_s.addressable_shards}
    print(f"shard placement: {blocks}")
    want_block = (SHAPE[0] // 2, SHAPE[1] // 2, SHAPE[2])
    if len(blocks) != 4 or any(b[0] != want_block for b in blocks.values()):
        raise V.VerifyError(f"expected one {want_block} block on each of "
                            f"four cards, got {blocks}")
    img_1 = jax.device_put(img, one)
    msk_1 = jax.device_put(msk, one)

    for s in FOUR_CARD_SCALES:
        with phase(f"sharded_features8 s={s} on 4 cards vs 1 card"):
            got = sharded_features8(img_s, msk_s, s, mesh, SPACING,
                                    stack=False)
            ref = features8_auto_channels(img_1, msk_1, s, SPACING)
            errs = V.feature_errors(
                np.stack([np.asarray(c) for c in got], -1),
                np.stack([np.asarray(c) for c in ref], -1))
            worst = V.check_within(f"sharded_features8 s={s}", errs)
            print(f"sharded_features8 s={s}: worst {worst:.3e} "
                  + " ".join(f"{k}={v:.2e}" for k, v in sorted(errs.items())))
        with phase(f"sharded_masked_histogram s={s} on 4 cards vs 1 card"):
            edges = jnp.asarray(np.linspace(-1000.0, 0.0, 31), jnp.float32)
            ch0 = jax.device_put(np.asarray(got[0]), one)
            a = sharded_masked_histogram(got[0], msk_s, edges, mesh)
            b = histogram_counts(ch0, edges, jax.device_put(
                (msk != 0).astype(np.int32), one))
            bad = V.count_mismatch(a, b)
            print(f"sharded_masked_histogram s={s}: max count mismatch "
                  f"{bad} over {int(np.asarray(b).sum())} counts")
            if bad:
                raise V.VerifyError(
                    f"sharded histogram counts differ by {bad}")
        del got, ref

    pairs = os.path.join(workdir, "pairs.txt")
    with open(pairs, "w") as fh:
        fh.write(f"{img_p},{msk_p}\n")
    spec = os.path.join(workdir, "spec4.txt")
    with phase(f"ife determine-bin-edges --sharded on 4 cards "
               f"({len(SCALES)} scales)"):
        ife("determine-bin-edges", "-l", pairs, "-o", spec,
            "-s", *[str(s) for s in SCALES], "--bins", BINS, "--sharded",
            "--foreground", 1, 2, "--fine-bins", FINE_BINS)
    got_edges = read_spec(spec)
    with phase("the same bin edges on 1 card"):
        mesh1 = make_mesh(1, ("x",), devices=[one])
        fg = np.isin(msk, (1, 2)).astype(np.uint8)
        hists = sharded_feature_fine_histograms(
            img, fg, SCALES, mesh1, SPACING, n_fine=FINE_BINS)
        want_edges, widths = [], []
        for bc in hists:
            bounds, counts = merge_fine_histograms([bc])
            want_edges.append(edges_from_dense_counts(bounds, counts, BINS))
            widths.append(bounds[1] - bounds[0])
    if got_edges.shape != (NUM_FEATURES * len(SCALES), BINS - 1):
        raise V.VerifyError(f"sharded spec shape {got_edges.shape}")
    rel = max(float(np.abs(g - w).max()) / wd
              for g, w, wd in zip(got_edges, want_edges, widths))
    print(f"determine-bin-edges --sharded 4 cards vs 1 card: max edge "
          f"difference {rel:.3e} fine-bin widths (budget 1)")
    if not rel <= 1.0:
        raise V.VerifyError(f"sharded bin edges differ by {rel} fine bins")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on a 2x2 mesh of four "
                   "cards and its one-card comparison")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    smi = V.read_nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)

    import jax

    jax.config.update("jax_platforms", "cuda")
    from ife_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    devices = V.require_gpu(jax.devices())
    d = devices[0]
    print(f"jax {jax.__version__}: platform={d.platform} "
          f"device_kind={d.device_kind} count={len(devices)}", flush=True)
    build_native()

    with tempfile.TemporaryDirectory(prefix="ife_smoke_") as workdir:
        if args.four_cards:
            if len(devices) < 4:
                raise RuntimeError(f"--four-cards needs 4 cards, found "
                                   f"{len(devices)}")
            four_cards_phase(devices, workdir, args.seed)
        else:
            with phase("verify on the card vs the f64 reference"):
                V.verify_on_device(SHAPE, seed=args.seed)
            with phase("f32-vs-f64 table, CT-like scan, every scale"):
                V.ct_precision_table(SHAPE, seed=args.seed)
            pipeline_phase(workdir, args.seed)
    stats = [dev.memory_stats() or {} for dev in devices]
    print("peak_bytes_in_use: "
          + ", ".join(f"{dev.id}:{st.get('peak_bytes_in_use')}"
                      for dev, st in zip(devices, stats)))
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(V.result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-device verification against the f64 NumPy reference.

The product paths run in f32 on the accelerator; `tests/numpy_ref.py`
re-derives the same semantics in f64 with scipy/numpy machinery. This
module, beside its two callers chip_smoke.py and bench.py, holds the
comparison rules they share, the device checks (a measurement must run on
a GPU, never fall back to the CPU), and the verify phase itself: every
dispatched entry point at a permanently unaligned shape and at full
clinical width, and the CT-like scan at full width at every scale.

Tolerances (relative to each channel's own scale, max(|ref|, 1)):
  * feature channels 0, 1, 5, 6, 7 (smoothed, |grad|, LoG, curvature,
    Frobenius): max abs error / scale <= 1e-4;
  * eigen channels 2-4: compared as value-sorted triples to the same
    budget — the |e|-ordering legitimately swaps at near-ties in f32;
  * histograms: integer-exact against np.searchsorted binning;
  * bags: within 1e-6 of the host path (checked by chip_smoke.py).
An f32 conv or dot running in TF32 (~1e-3 relative) fails the 1e-4
budget, so the feature entries double as the TF32 trap.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import math
import os
import subprocess
from typing import Dict, Sequence

import numpy as np

BUDGET = 1e-4
DIRECT_CHANNELS = (0, 1, 5, 6, 7)
SPACING = (0.78, 0.78, 1.0)
SCALES = (0.6, 1.2, 2.4, 4.8)
UNALIGNED_SHAPE = (128, 124, 120)
FULL_WIDTH_SCALES = (0.6, 4.8)   # the full-width features8 entries
CORE = 8                         # x-rows per reference slab at full width


class VerifyError(AssertionError):
    """An on-device result disagreed with the reference."""


@functools.lru_cache(maxsize=1)
def numpy_reference():
    """tests/numpy_ref.py of this checkout, loaded by path: a `tests`
    package installed elsewhere must not shadow it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "numpy_ref.py")
    spec = importlib.util.spec_from_file_location("ife_numpy_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# comparison rules
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.size == 0:
        return 0.0
    scale = max(float(np.abs(want).max()), 1.0)
    return float(np.abs(got - want).max()) / scale


def feature_errors(got, want) -> Dict[str, float]:
    """Errors of an (..., 8) feature result against its (..., 8)
    reference: one entry per channel ("c0".."c7") plus "eig_sorted",
    the value-sorted eigen triple."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or got.shape[-1] != 8:
        raise VerifyError(f"shape {got.shape} != reference {want.shape}")
    errs = {f"c{c}": _rel(got[..., c], want[..., c]) for c in range(8)}
    errs["eig_sorted"] = _rel(np.sort(got[..., 2:5], axis=-1),
                              np.sort(want[..., 2:5], axis=-1))
    return errs


def eigen_feature_errors(got, want) -> Dict[str, float]:
    """Errors of an (..., 6) Hessian eigen-feature result: the first
    three channels value-sorted ("eig_sorted"), the symmetric functions
    directly ("sum", "prod", "frob")."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or got.shape[-1] != 6:
        raise VerifyError(f"shape {got.shape} != reference {want.shape}")
    errs = {k: _rel(got[..., c], want[..., c])
            for c, k in ((3, "sum"), (4, "prod"), (5, "frob"))}
    errs["eig_sorted"] = _rel(np.sort(got[..., :3], axis=-1),
                              np.sort(want[..., :3], axis=-1))
    return errs


def budgeted(errs: Dict[str, float]) -> Dict[str, float]:
    """The entries of an error dict that the budget applies to: the
    direct channels and the sorted eigen triple (channels 2-4 as
    compared one by one are reported, not budgeted)."""
    keys = ([f"c{c}" for c in DIRECT_CHANNELS]
            + ["sum", "prod", "frob", "eig_sorted"])
    return {k: v for k, v in errs.items() if k in keys}


def check_within(name: str, errs: Dict[str, float],
                 budget: float = BUDGET) -> float:
    """Raise VerifyError if any budgeted entry exceeds the budget (or is
    not finite); return the worst budgeted error."""
    b = budgeted(errs) or errs
    worst = max(b.values())
    bad = {k: v for k, v in b.items() if not (v <= budget)}
    if bad:
        raise VerifyError(f"{name}: {bad} over budget {budget:g}")
    return worst


def count_mismatch(got, want) -> int:
    """Largest absolute count difference; histograms must give 0."""
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    if got.shape != want.shape:
        raise VerifyError(f"counts shape {got.shape} != {want.shape}")
    return int(np.abs(got - want).max()) if got.size else 0


def searchsorted_counts(values, edges, weights=None) -> np.ndarray:
    """The definitional oracle: searchsorted-left bin index, bincount."""
    idx = np.searchsorted(np.asarray(edges, np.float64),
                          np.asarray(values, np.float64).reshape(-1),
                          side="left")
    w = None if weights is None else np.asarray(weights).reshape(-1)
    return np.bincount(idx, weights=w, minlength=len(edges) + 1
                       ).astype(np.int64)


# ---------------------------------------------------------------------------
# the device: a GPU, named, or nothing
# ---------------------------------------------------------------------------

def parse_nvidia_smi(text: str):
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output -> [(name, power_limit), ...], one per card. Raises
    ValueError on anything else."""
    cards = []
    for line in text.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 2 or not parts[0] or not parts[1]:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((parts[0], parts[1]))
    if not cards:
        raise ValueError("nvidia-smi reported no GPU")
    return cards


def read_nvidia_smi(timeout: float = 30.0) -> str:
    """The raw query output, read in a child process that stays off JAX.
    Raises RuntimeError when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot read nvidia-smi: {e}") from e
    parse_nvidia_smi(out)
    return out.strip()


def require_gpu(devices=None):
    """The JAX devices, which must be GPUs; raises RuntimeError
    otherwise (no CPU fallback for anything measured or verified)."""
    if devices is None:
        import jax

        devices = jax.devices()
    if not devices or any(d.platform != "gpu" for d in devices):
        kinds = sorted({d.platform for d in devices})
        raise RuntimeError(f"needs a GPU, JAX found platform(s) {kinds}")
    return devices


def result_line(devices) -> str:
    """The one-line JSON result the smoke run ends with."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def lung_mask(shape: Sequence[int]) -> np.ndarray:
    """Two ellipsoids, labels 1 (right lung) and 2 (left lung), with
    semi-axes of 17%, 30% and 40% of X, Y and Z — a lung-like mask (~17%
    of the volume) that also exercises the label clamp of the feature
    pass."""
    X, Y, Z = shape
    x, y, z = np.ogrid[:X, :Y, :Z]
    m = np.zeros(shape, np.uint8)
    for label, cx in ((1, 0.3), (2, 0.7)):
        r2 = (((x - cx * (X - 1)) / (0.17 * X)) ** 2
              + ((y - 0.5 * (Y - 1)) / (0.3 * Y)) ** 2
              + ((z - 0.5 * (Z - 1)) / (0.4 * Z)) ** 2)
        m[r2 <= 1.0] = label
    return m


def scan(shape: Sequence[int], seed: int):
    """(image f32, lung mask uint8) as host arrays, from a seed: the
    CT-like data of the pipeline phase."""
    from ife_tpu.core.volume import synthetic_ct

    img = np.asarray(synthetic_ct(tuple(shape), seed=seed).data, np.float32)
    return img, lung_mask(shape)


def gate_scan(shape: Sequence[int], seed: int):
    """(image f32, mask uint8) for the entry-point checks: white noise of
    200 around -600 with a random 75% mask — the data class of the
    earlier on-chip gate that set the 1e-4 budget. Every voxel and face
    case is hit and every scale carries large second derivatives. The
    smooth CT-like scan is the harder case for f32 (small Hessians at
    large sigma against the rounding of a field hundreds of HU wide,
    times 4/h^2); ct_precision_table holds it to the same budget."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(tuple(shape), dtype=np.float32) * 200 - 600
    msk = (rng.uniform(size=tuple(shape)) > 0.25).astype(np.uint8)
    return img, msk


# ---------------------------------------------------------------------------
# the verify phase
# ---------------------------------------------------------------------------

def _slab_reference(img, msk, sigma, spacing, x0, x1):
    """f64 reference features on x-rows [x0, x1) of a full volume,
    computed on an x-slab extended by the smoothing radius plus the
    stencil reach on each side that is not a true face — exact on the
    kept rows, which never see the slab's cut faces. Every slab holds
    the true faces of Y and Z."""
    ref = numpy_reference()

    reach = max(1, math.ceil(4.5 * sigma / spacing[0])) + 4
    lo = max(0, x0 - reach)
    hi = min(img.shape[0], x1 + reach)
    f = ref.features8_np(img[lo:hi].astype(np.float64), msk[lo:hi],
                         sigma, spacing)
    return f[x0 - lo:x1 - lo]


def _slab_errors(f, img, msk, sigma, spacing, rows):
    """feature_errors of device features `f` against the f64 reference
    on the x-row ranges `rows`."""
    got = np.concatenate([np.asarray(f[a:b]) for a, b in rows])
    want = np.concatenate([_slab_reference(img, msk, sigma, spacing, a, b)
                           for a, b in rows])
    return feature_errors(got, want)


def verify_on_device(full_shape, seed: int = 0,
                     log=print) -> Dict[str, float]:
    """Run every dispatched entry point on the default device and compare
    it with the f64 reference. Entries:
      * the unaligned scan (128, 124, 120) at the four scales:
        features8_auto, features8_auto_channels,
        normalized_convolution_auto and sharded_features8 on a 1-device
        mesh;
      * hessian_eig_features and sharded_hessian_eig at that shape;
      * histogram_counts, uniform_histogram_counts and their sharded
        wrappers, integer-exact;
      * features8_auto at full width (full_shape) for FULL_WIDTH_SCALES,
        against slab references that hold all six true faces; the
        per-channel f32-vs-f64 errors are logged.
    Returns {entry: worst budgeted error (or count mismatch)}; raises
    VerifyError on the first failure."""
    import jax
    import jax.numpy as jnp

    ref = numpy_reference()
    from ife_tpu.ops.features import (
        features8_auto, features8_auto_channels, hessian_eig_features,
        normalized_convolution_auto,
    )
    from ife_tpu.parallel import (
        make_mesh, masked_fine_histogram, shard_volume, sharded_features8,
        sharded_hessian_eig, sharded_masked_histogram,
    )
    from ife_tpu.stats.histogram import (
        histogram_counts, snap_pow2_grid, uniform_histogram_counts,
    )

    report: Dict[str, float] = {}

    def record(name, errs):
        worst = check_within(name, errs)
        report[name] = worst
        log(f"verify {name}: worst {worst:.3e} (budget {BUDGET:g}) "
            + " ".join(f"{k}={v:.2e}" for k, v in sorted(errs.items())))

    def record_counts(name, got, want):
        bad = count_mismatch(got, want)
        report[name] = float(bad)
        log(f"verify {name}: max count mismatch {bad} over "
            f"{int(np.asarray(want).sum())} counts")
        if bad:
            raise VerifyError(f"{name}: counts differ by {bad}")

    mesh1 = make_mesh(1, ("x",), devices=jax.devices()[:1])

    # ---- the permanently unaligned scan (Y % 8 != 0, Z % 128 != 0) ----
    img_u, msk_u = gate_scan(UNALIGNED_SHAPE, seed)
    img_d, msk_d = jnp.asarray(img_u), jnp.asarray(msk_u)
    img_s, msk_s = shard_volume(img_d, mesh1), shard_volume(msk_d, mesh1)
    inside = msk_u != 0
    for s in SCALES:
        want = ref.features8_np(img_u.astype(np.float64), msk_u, s, SPACING)
        record(f"features8_auto[{UNALIGNED_SHAPE} s={s}]", feature_errors(
            np.asarray(features8_auto(img_d, msk_d, s, SPACING)), want))
        chans = features8_auto_channels(img_d, msk_d, s, SPACING)
        record(f"features8_auto_channels[{UNALIGNED_SHAPE} s={s}]",
               feature_errors(np.stack([np.asarray(c) for c in chans], -1),
                              want))
        sh = sharded_features8(img_s, msk_s, s, mesh1, SPACING, stack=False)
        record(f"sharded_features8[1-device mesh s={s}]", feature_errors(
            np.stack([np.asarray(c) for c in sh], -1), want))
        nc = np.asarray(normalized_convolution_auto(
            img_d, msk_d.astype(jnp.float32), s, SPACING))
        nc_ref = ref.normalized_conv_np(img_u.astype(np.float64),
                                        msk_u.astype(np.float64), s, SPACING)
        record(f"normalized_convolution_auto[{UNALIGNED_SHAPE} s={s}]",
               {"c0": _rel(nc[inside], nc_ref[inside])})

    want_h = ref.eig_features_np(ref.hessian_np(img_u.astype(np.float64),
                                                SPACING))
    record(f"hessian_eig_features[{UNALIGNED_SHAPE}]", eigen_feature_errors(
        np.asarray(hessian_eig_features(img_d, SPACING)), want_h))
    record("sharded_hessian_eig[1-device mesh]", eigen_feature_errors(
        np.asarray(sharded_hessian_eig(img_s, mesh1, SPACING)), want_h))

    edges = np.linspace(-1100.0, -100.0, 31).astype(np.float32)
    record_counts("sharded_masked_histogram[1-device mesh, 31 edges]",
                  sharded_masked_histogram(img_s, msk_s, jnp.asarray(edges),
                                           mesh1),
                  searchsorted_counts(img_u[inside], edges))
    bounds, counts = masked_fine_histogram(img_s, msk_s, mesh1, 4096)
    raw = searchsorted_counts(img_u[inside], bounds)
    fine_ref = raw[1:4097].copy()
    fine_ref[0] += raw[0]
    record_counts("masked_fine_histogram[1-device mesh, 4096 bins]",
                  counts, fine_ref)

    # ---- full clinical width ----
    img_f, msk_f = gate_scan(full_shape, seed + 1)
    img_fd, msk_fd = jnp.asarray(img_f), jnp.asarray(msk_f)
    X = full_shape[0]
    faces = ((0, CORE), (X - CORE, X))
    for s in FULL_WIDTH_SCALES:
        f = features8_auto(img_fd, msk_fd, s, SPACING)
        record(f"features8_auto[{full_shape} s={s}, x-face slabs]",
               _slab_errors(f, img_f, msk_f, s, SPACING, faces))
        if s == FULL_WIDTH_SCALES[0]:
            # histograms of the full-width smoothed channel, masked
            ch = f[..., 0]
            w01 = (msk_fd != 0).astype(jnp.int32)
            ch_np = np.asarray(ch)
            vals = ch_np[msk_f != 0]
            record_counts(f"histogram_counts[{full_shape}, 31 edges]",
                          histogram_counts(ch, jnp.asarray(edges), w01),
                          searchsorted_counts(ch_np, edges,
                                              (msk_f != 0).astype(np.int64)))
            m, k, bnd = snap_pow2_grid(float(vals.min()), float(vals.max()),
                                       4096)
            got_u = uniform_histogram_counts(
                ch, w01, jnp.float32(m), jnp.float32(np.ldexp(1.0, k)), 4096)
            raw = searchsorted_counts(vals, bnd)
            want_u = raw[1:4097].copy()
            want_u[0] += raw[0]
            record_counts(f"uniform_histogram_counts[{full_shape}, 4096 "
                          "bins]", got_u, want_u)
        del f
    return report


def ct_precision_table(shape, seed: int = 0,
                       log=print) -> Dict[float, Dict[str, float]]:
    """Per-channel f32-vs-f64 error of features8_auto on the CT-like scan
    (synthetic CT, lung mask) at full width and every scale, on an
    x-slab through the middle of each lung. Every scale is logged
    first; then the direct channels and the sorted eigen triple are held
    to BUDGET (VerifyError on the first scale over it)."""
    import jax.numpy as jnp

    from ife_tpu.ops.features import FEATURE_NAMES, features8_auto

    img, msk = scan(shape, seed)
    img_d, msk_d = jnp.asarray(img), jnp.asarray(msk)
    X = shape[0]
    rows = [(int(c * X) - CORE // 2, int(c * X) - CORE // 2 + CORE)
            for c in (0.3, 0.7)]
    table = {}
    for s in SCALES:
        f = features8_auto(img_d, msk_d, s, SPACING)
        errs = table[s] = _slab_errors(f, img, msk, s, SPACING, rows)
        del f
        log(f"precision {tuple(shape)} s={s}: "
            + ", ".join(f"{name} {errs[f'c{c}']:.3e}"
                        for c, name in enumerate(FEATURE_NAMES))
            + f", eigenvalues (sorted) {errs['eig_sorted']:.3e}")
    for s, errs in table.items():
        check_within(f"CT-like scan {tuple(shape)} s={s}", errs)
    return table

"""Subcommand implementations for the `ife` CLI.

Each entry mirrors one reference tool (SURVEY.md §2.2). REGISTRY maps
subcommand name -> (configure(parser), run(args), help). JAX imports are
deferred into run() so `ife --help` stays instant.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _triple(s: str, cast=int):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 3:
        raise ValueError(f"expected 3 comma-separated values, got {s!r}")
    return tuple(cast(p) for p in parts)


def _pair(s: str, cast=int):
    parts = [p for p in s.replace(",", " ").split() if p]
    if len(parts) != 2:
        raise ValueError(f"expected 2 comma-separated values, got {s!r}")
    return tuple(cast(p) for p in parts)


def _load(path):
    from ife_tpu.io import read_volume

    return read_volume(path)


def _save(path, vol):
    from ife_tpu.io import write_volume

    write_volume(path, vol)


def _progress(msg: str):
    # reference tools print progress lines to stdout (MakeBag.cxx:406)
    print(msg, flush=True)


def _get_rois(args, mask_np, default_size=(41, 41, 41)):
    """ROI source resolution shared by the bag tools: explicit ROI file, or
    random generation (MakeBag.cxx:272-317)."""
    from ife_tpu.io import read_rois
    from ife_tpu.roi import generate_random_rois

    if getattr(args, "roi_file", None):
        return read_rois(args.roi_file, header=getattr(args, "roi_header", False))
    size = getattr(args, "roi_size", None) or default_size
    return generate_random_rois(
        mask_np, n=args.num_rois, size=size, seed=getattr(args, "seed", None)
    )


# ---------------------------------------------------------------------------
# feature tools
# ---------------------------------------------------------------------------

def _init_distributed(args):
    """Shared --sharded runtime setup: multi-host init (no-op without a
    coordinator), global mesh over ALL devices, optional restart manifest.
    Returns (mesh, manifest, primary)."""
    import jax
    from ife_tpu.parallel import make_mesh
    from ife_tpu.parallel.launcher import (
        ShardManifest,
        distributed_init_from_args,
        is_primary,
    )

    pid, nprocs = distributed_init_from_args(args)
    n = jax.device_count()
    mesh = make_mesh(n, ("x", "y") if n > 1 else ("x",))
    _progress(f"process {pid}/{nprocs}: sharding over {n} devices: "
              f"{dict(zip(mesh.axis_names, mesh.devices.shape))}")
    manifest_path = getattr(args, "manifest", None)
    if manifest_path and nprocs > 1:
        # per-process manifest (and caches derived from it): restartable
        # WITHOUT assuming a shared filesystem across hosts — every
        # process keeps its own completion ledger; on a shared FS the
        # per-process files simply coexist
        manifest_path = f"{manifest_path}.p{pid}"
    manifest = ShardManifest(manifest_path) if manifest_path else None
    return mesh, manifest, is_primary()


def _add_distributed_flags(p):
    """Flags shared by every --sharded-capable subcommand (no jax import —
    parser construction must stay instant)."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator address "
                   "(or env IFE_COORDINATOR); single-process if unset")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (or env IFE_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index (or env IFE_PROCESS_ID)")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="shard-manifest JSON: completed blocks are skipped "
                   "on restart (failure recovery)")


def conf_extract_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="block-shard the volume over all devices — local or "
                   "multi-host with --coordinator (halo-exchange parallel path)")
    _add_distributed_flags(p)


def run_extract_features(args):
    """Reference tools/ExtractFeatures.cxx: per scale, 8 feature volumes
    written as <out>_scale_<s><FeatureName>.nii.gz.

    --sharded runs each scale block-sharded over every device of every
    process; --manifest makes the run restartable (completed scales are
    skipped, the reference's file-materialized stage contract made
    explicit, SURVEY.md §5)."""
    import jax
    import jax.numpy as jnp
    from ife_tpu.ops.features import features8_auto, FEATURE_NAMES
    from ife_tpu.utils import stage_timer

    mesh = manifest = None
    primary = True
    if args.sharded:
        mesh, manifest, primary = _init_distributed(args)

    vol = _load(args.image)
    mask = _load(args.mask)
    img = jnp.asarray(vol.data, jnp.float32)
    msk = jnp.asarray(mask.data)
    for s in args.scales:
        key = f"scale_{s:g}"
        last_out = f"{args.out}_scale_{s:g}{FEATURE_NAMES[-1]}.nii.gz"
        if manifest is not None and manifest.is_done(key):
            _progress(f"Skipping completed scale {s:g} (manifest)")
            continue
        _progress(f"Processing scale {s:g}")
        with stage_timer(f"features8[s={s:g}]", voxels=img.size, emit=True):
            if mesh is not None:
                from ife_tpu.parallel import features8_sharded_auto
                from ife_tpu.parallel.launcher import fetch_to_host

                feats = fetch_to_host(features8_sharded_auto(
                    img, msk, float(s), mesh, vol.spacing))
            else:
                feats = np.asarray(features8_auto(
                    img, msk, float(s), vol.spacing))
        if primary:
            for c, name in enumerate(FEATURE_NAMES):
                out = vol.with_data(feats[..., c])
                _save(f"{args.out}_scale_{s:g}{name}.nii.gz", out)
        if manifest is not None:
            # every process records completion in its OWN manifest so a
            # restart keeps the collective schedule in lockstep across
            # hosts; non-primary passes no path (the output .nii.gz lives
            # on the primary's filesystem)
            manifest.mark_done(key, last_out if primary else None)


def conf_masked_normalized_convolution(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-c", "--certainty", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--mask-output", action="store_true",
                   help="zero the output outside the certainty support")


def run_masked_normalized_convolution(args):
    """Reference tools/MaskedNormalizedConvolution.cxx:141-203."""
    import jax.numpy as jnp
    from ife_tpu.ops.features import normalized_convolution_auto

    vol = _load(args.image)
    cert = _load(args.certainty)
    img = jnp.asarray(vol.data, jnp.float32)
    c = jnp.asarray(cert.data, jnp.float32)
    for s in args.scales:
        _progress(f"Processing scale {s:g}")
        out = normalized_convolution_auto(img, c, float(s), vol.spacing)
        if args.mask_output:
            out = jnp.where(c != 0, out, 0.0)
        else:
            out = jnp.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
        _save(f"{args.out}scale_{s:g}.nii.gz", vol.with_data(np.asarray(out)))


def conf_hessian_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", default=None)
    p.add_argument("-o", "--out", required=True, help="output prefix")


def run_hessian_features(args):
    """Raw (unsmoothed) Hessian eigen-feature volumes. Capability of the
    dead reference tool FiniteDifference_HessianFeatures (tools/...cxx,
    not built; its Dy-direction bug at :153-156 is NOT replicated — the
    live Hessian3DImageFilter wiring is the spec, SURVEY.md §7)."""
    import jax.numpy as jnp
    from ife_tpu.ops.features import hessian_eig_features

    vol = _load(args.image)
    img = jnp.asarray(vol.data, jnp.float32)
    names = ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3",
             "LaplacianOfGaussian", "GaussianCurvature", "FrobeniusNorm")
    feats = np.asarray(hessian_eig_features(img, vol.spacing))
    if args.mask:
        mask = _load(args.mask)
        feats = feats * (np.asarray(mask.data) != 0)[..., None]
    for c, name in enumerate(names):
        _save(f"{args.out}{name}.nii.gz", vol.with_data(feats[..., c]))


def conf_gradient_features(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)


def run_gradient_features(args):
    """Reference tools/FiniteDifference_GradientFeatures.cxx:104-137:
    masked central-difference gradient magnitude."""
    import jax.numpy as jnp
    from ife_tpu.ops.stencil import gradient_magnitude

    vol = _load(args.image)
    mask = _load(args.mask)
    gm = gradient_magnitude(jnp.asarray(vol.data, jnp.float32), vol.spacing)
    gm = jnp.where(jnp.asarray(mask.data) != 0, gm, 0.0)
    _save(args.out, vol.with_data(np.asarray(gm)))


# ---------------------------------------------------------------------------
# bag tools
# ---------------------------------------------------------------------------

def _conf_bag_common(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-b", "--bins", dest="hist_spec", required=True,
                   help="histogram spec file (bin edges)")
    p.add_argument("-o", "--out", required=True, help="output prefix")


def conf_make_bag(p):
    _conf_bag_common(p)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("-r", "--roi-file", default=None)
    p.add_argument("--roi-header", action="store_true")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", action="store_true",
                   help="histogram the ROIs on device (mixed ROI sizes run per size class)")
    p.add_argument("--sharded", action="store_true",
                   help="block-shard the feature pass over all devices; the "
                   "feature volume never touches the host (mixed ROI sizes "
                   "run per size class)")
    _add_distributed_flags(p)


def run_make_bag(args):
    """Reference tools/MakeBag.cxx: per-ROI concatenated feature histograms
    -> <prefix>.bag CSV + <prefix>.ROIInfo.

    --sharded keeps the per-scale feature volumes block-sharded on the mesh
    and fetches only the (n_rois, 8, bins) frequency block — the scalable
    form of the reference's host-side loop (MakeBag.cxx:405-486)."""
    from ife_tpu.io import read_hist_spec, write_rois
    from ife_tpu.io.text import write_matrix_csv
    from ife_tpu.roi import make_bag
    from ife_tpu.roi.bag import make_bag_device, make_bag_sharded

    primary = True
    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    mask_np = np.asarray(mask.data)
    if args.sharded:
        mesh, _, primary = _init_distributed(args)
        if getattr(args, "roi_file", None) is None and args.seed is None:
            # every process must draw IDENTICAL ROIs, but the default must
            # stay a fresh random sampling exactly like the unsharded run:
            # the primary draws entropy and broadcasts it. The seed is
            # printed so the run is reproducible after the fact.
            import secrets
            import jax
            seed = secrets.randbits(31)
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils
                seed = int(multihost_utils.broadcast_one_to_all(
                    np.asarray([seed], dtype=np.int64))[0])
            args.seed = seed
            _progress(f"--sharded ROI seed {seed} "
                      "(drawn on primary, broadcast to all processes; "
                      "pass --seed to reproduce)")
        rois = _get_rois(args, mask_np)
        bag = make_bag_sharded(np.asarray(vol.data), mask_np, args.scales,
                               edges, rois, mesh, spacing=vol.spacing)
    else:
        rois = _get_rois(args, mask_np)
        bag_fn = make_bag_device if getattr(args, "device", False) else make_bag
        bag = bag_fn(np.asarray(vol.data), mask_np, args.scales, edges, rois,
                     spacing=vol.spacing)
    if primary:
        write_matrix_csv(f"{args.out}.bag", bag)
        write_rois(f"{args.out}.ROIInfo", rois)
    _progress(f"Wrote {bag.shape[0]} ROIs x {bag.shape[1]} columns")


def conf_make_bag_dense(p):
    _conf_bag_common(p)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")


def run_make_bag_dense(args):
    """Reference tools/MakeBagDense.cxx: every foreground voxel is an ROI
    center (DenseROIGenerator)."""
    from ife_tpu.io import read_hist_spec, write_rois
    from ife_tpu.io.text import write_matrix_csv
    from ife_tpu.roi import generate_dense_rois, make_bag

    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    mask_np = np.asarray(mask.data)
    rois = generate_dense_rois(mask_np, args.roi_size)
    bag = make_bag(np.asarray(vol.data), mask_np, args.scales, edges, rois,
                   spacing=vol.spacing)
    write_matrix_csv(f"{args.out}.bag", bag)
    write_rois(f"{args.out}.ROIInfo", rois)
    _progress(f"Wrote {bag.shape[0]} ROIs x {bag.shape[1]} columns")


def conf_make_bag_only_intensity(p):
    _conf_bag_common(p)
    p.add_argument("-r", "--roi-file", default=None)
    p.add_argument("--roi-header", action="store_true")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--seed", type=int, default=None)


def run_make_bag_only_intensity(args):
    """Reference tools/MakeBagOnlyIntensity.cxx: raw intensity, single
    histogram (check at :326-330)."""
    from ife_tpu.io import read_hist_spec, write_rois
    from ife_tpu.io.text import write_matrix_csv
    from ife_tpu.roi.bag import make_bag_intensity

    vol = _load(args.image)
    mask = _load(args.mask)
    edges = read_hist_spec(args.hist_spec)
    if len(edges) != 1:
        raise ValueError("intensity bags use exactly one histogram row")
    mask_np = np.asarray(mask.data)
    rois = _get_rois(args, mask_np)
    bag = make_bag_intensity(np.asarray(vol.data), mask_np, edges[0], rois)
    write_matrix_csv(f"{args.out}.bag", bag)
    write_rois(f"{args.out}.ROIInfo", rois)


def conf_determine_bin_edges(p):
    p.add_argument("-l", "--pair-list", required=True,
                   help="text file: image,mask per line")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-s", "--scales", type=float, nargs="+", required=True)
    p.add_argument("--bins", type=int, required=True)
    p.add_argument("--samples", type=int, default=0,
                   help="random samples per image (0 = all masked voxels)")
    p.add_argument("--foreground", type=int, nargs="+", default=[1],
                   help="mask labels counted as foreground")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sharded", action="store_true",
                   help="scalable path: features stay block-sharded on the "
                   "mesh, per-image fine histograms psum-reduce, edges come "
                   "from CDF inversion (approximate; replaces the global sort)")
    p.add_argument("--fine-bins", type=int, default=4096,
                   help="fine pre-histogram resolution for --sharded")
    _add_distributed_flags(p)


def _foreground_mask(arr: np.ndarray, labels) -> np.ndarray:
    """Membership of arr values in the (small) foreground label list.

    np.isin takes a sort-based path; a per-label equality OR is O(k)
    vectorized passes, for the typical 1-3 labels.
    """
    labels = list(labels)
    fg = np.zeros(np.shape(arr), bool)
    for v in labels:
        fg |= (arr == v)
    return fg


def _run_determine_bin_edges_sharded(args):
    """Scalable bin-edge path (SURVEY.md §7 hard-part 4): per image, per
    (scale, feature), an on-mesh fine histogram (min/max psum + dense-count
    psum, parallel/stats.py); per-image histograms merge across images by
    piecewise-linear CDF resampling; the equalized edges invert the merged
    CDF. Replaces the reference's all-samples global sort
    (DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures.cxx:283) which
    needs every sample in one address space. --manifest caches per-image
    histograms in <manifest>.<image-index>.npz so restarts skip completed
    images."""
    import jax.numpy as jnp
    from ife_tpu.io import read_pair_list, write_hist_spec
    from ife_tpu.ops.features import FEATURE_NAMES, NUM_FEATURES
    from ife_tpu.parallel.launcher import is_primary
    from ife_tpu.parallel.stats import (
        merge_fine_histograms,
        sharded_feature_fine_histograms,
    )
    from ife_tpu.stats.equalize import edges_from_dense_counts

    mesh, manifest, primary = _init_distributed(args)
    pairs = read_pair_list(args.pair_list)
    n_hists = NUM_FEATURES * len(args.scales)
    per_hist = [[] for _ in range(n_hists)]
    for idx, (img_path, mask_path) in enumerate(pairs):
        key = f"image_{idx}"
        # cache path derives from the manifest's ACTUAL (per-process)
        # path, so multi-host restarts never read another host's files
        cache = (f"{manifest.path}.{idx}.npz"
                 if manifest is not None else None)
        if manifest is not None and manifest.is_done(key) and cache:
            _progress(f"Loading cached histograms for {img_path} (manifest)")
            z = np.load(cache)
            for h in range(n_hists):
                per_hist[h].append((z[f"bounds_{h}"], z[f"counts_{h}"]))
            continue
        _progress(f"Processing {img_path} / {mask_path}")
        vol = _load(img_path)
        mask = _load(mask_path)
        fg = _foreground_mask(np.asarray(mask.data), args.foreground)
        hists = sharded_feature_fine_histograms(
            np.asarray(vol.data), fg.astype(np.uint8), args.scales, mesh,
            vol.spacing, n_fine=args.fine_bins,
        )
        for h, bc in enumerate(hists):
            per_hist[h].append(bc)
        if manifest is not None:
            # every process writes its own cache + ledger (per-process
            # manifest path) — no shared-filesystem assumption
            np.savez(
                cache,
                **{f"bounds_{h}": b for h, (b, _) in enumerate(hists)},
                **{f"counts_{h}": c for h, (_, c) in enumerate(hists)},
            )
            manifest.mark_done(key, cache)
    edge_rows = []
    for vals in per_hist:
        bounds, counts = merge_fine_histograms(vals)
        edge_rows.append(edges_from_dense_counts(bounds, counts, args.bins))
    if primary:
        write_hist_spec(args.out, edge_rows, scales=args.scales,
                        feature_names=FEATURE_NAMES)


def run_determine_bin_edges(args):
    """Reference tools/DetermineHistogramBinEdges_MultiScaleEigenvalue
    Features.cxx: per (scale, feature) equal-frequency edges over a sample
    of masked feature voxels from all listed images."""
    import jax.numpy as jnp
    from ife_tpu.io import read_pair_list, write_hist_spec
    from ife_tpu.ops.features import features8_auto, FEATURE_NAMES, NUM_FEATURES
    from ife_tpu.stats.equalize import determine_edges_for_equalized_histogram

    if args.sharded:
        return _run_determine_bin_edges_sharded(args)

    pairs = read_pair_list(args.pair_list)
    rng = np.random.default_rng(args.seed)
    samples = [[] for _ in range(NUM_FEATURES * len(args.scales))]
    for img_path, mask_path in pairs:
        _progress(f"Processing {img_path} / {mask_path}")
        vol = _load(img_path)
        mask = _load(mask_path)
        mask_np = np.asarray(mask.data)
        fg = _foreground_mask(mask_np, args.foreground)
        img = jnp.asarray(vol.data, jnp.float32)
        msk = jnp.asarray(fg.astype(np.uint8))
        for i, s in enumerate(args.scales):
            feats = np.asarray(
                features8_auto(img, msk, float(s), vol.spacing)
            )
            sel = feats[fg]  # (n, 8)
            if args.samples > 0 and sel.shape[0] > args.samples:
                sel = sel[rng.choice(sel.shape[0], args.samples, replace=False)]
            for k in range(NUM_FEATURES):
                samples[i * NUM_FEATURES + k].append(sel[:, k])
    edge_rows = []
    for vals in samples:
        v = np.sort(np.concatenate(vals))
        edge_rows.append(determine_edges_for_equalized_histogram(v, args.bins))
    write_hist_spec(args.out, edge_rows, scales=args.scales,
                    feature_names=FEATURE_NAMES)


# ---------------------------------------------------------------------------
# ROI tools
# ---------------------------------------------------------------------------

def conf_generate_rois(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--size", type=_triple, default=(53, 53, 41), metavar="X,Y,Z")
    p.add_argument("--mask-value", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)


def run_generate_rois(args):
    """Reference tools/GenerateROIs.cxx:127-163."""
    from ife_tpu.io import write_rois
    from ife_tpu.roi import generate_random_rois

    mask = _load(args.mask)
    binary = (np.asarray(mask.data) == args.mask_value).astype(np.uint8)
    rois = generate_random_rois(binary, n=args.num_rois, size=args.size,
                                seed=args.seed)
    write_rois(args.out, rois)


def conf_generate_rois_many_regions(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("-n", "--num-rois", type=int, default=50)
    p.add_argument("--size", type=_triple, default=(53, 53, 41), metavar="X,Y,Z")
    p.add_argument("--labels", type=int, nargs="+", default=None,
                   help="default: every nonzero label present")
    p.add_argument("--seed", type=int, default=None)


def run_generate_rois_many_regions(args):
    """Reference tools/GenerateROIsManyRegions.cxx:151-176: one ROI file
    per mask label."""
    from ife_tpu.io import write_rois
    from ife_tpu.roi import generate_random_rois

    mask = _load(args.mask)
    m = np.asarray(mask.data)
    labels = args.labels or sorted(int(v) for v in np.unique(m) if v != 0)
    for lab in labels:
        binary = (m == lab).astype(np.uint8)
        rois = generate_random_rois(binary, n=args.num_rois, size=args.size,
                                    seed=args.seed)
        write_rois(f"{args.out}_{lab}.ROIInfo", rois)
        _progress(f"label {lab}: {len(rois)} ROIs")


def conf_sample_rois(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-r", "--roi-file", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--roi-header", action="store_true")


def run_sample_rois(args):
    """Reference tools/SampleROIs.cxx:104-170."""
    from ife_tpu.io import read_rois
    from ife_tpu.io.text import write_matrix_csv
    from ife_tpu.roi.bag import sample_rois

    vol = _load(args.image)
    rois = read_rois(args.roi_file, header=args.roi_header)
    write_matrix_csv(args.out, sample_rois(np.asarray(vol.data), rois))


def conf_extract_labels(p):
    p.add_argument("-l", "--label-image", required=True)
    p.add_argument("-r", "--roi-file", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--ignore", type=int, nargs="+", default=[])
    p.add_argument("--dominant", type=int, default=None)
    p.add_argument("--dominant-threshold", type=float, default=0.0)
    p.add_argument("--roi-header", action="store_true")


def run_extract_labels(args):
    """Reference tools/ExtractLabels.cxx:165-210."""
    from ife_tpu.io import read_rois
    from ife_tpu.roi.bag import extract_labels

    vol = _load(args.label_image)
    rois = read_rois(args.roi_file, header=args.roi_header)
    labels = extract_labels(np.asarray(vol.data), rois, ignore=args.ignore,
                            dominant=args.dominant,
                            dominant_threshold=args.dominant_threshold)
    with open(args.out, "w") as f:
        for lab in labels:
            f.write(f"{lab}\n")


# ---------------------------------------------------------------------------
# image utility tools
# ---------------------------------------------------------------------------

def conf_masked_image_filter(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--outside", type=float, default=0.0)


def run_masked_image_filter(args):
    import jax.numpy as jnp
    from ife_tpu.ops.transform import mask_image

    vol = _load(args.image)
    mask = _load(args.mask)
    out = mask_image(jnp.asarray(vol.data), jnp.asarray(mask.data), args.outside)
    _save(args.out, vol.with_data(np.asarray(out)))


def conf_extract_masked_region(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--include", type=int, nargs="+", required=True)
    p.add_argument("--inside", type=int, default=1)
    p.add_argument("--outside", type=int, default=0)


def run_extract_masked_region(args):
    import jax.numpy as jnp
    from ife_tpu.ops.transform import relabel_mask

    mask = _load(args.mask)
    out = relabel_mask(jnp.asarray(mask.data), args.include, args.inside,
                       args.outside)
    _save(args.out, mask.with_data(np.asarray(out)))


def conf_extract_bounding_box(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-o", "--out", required=True)


def run_extract_bounding_box(args):
    from ife_tpu.ops.transform import crop_to_bounding_box

    vol = _load(args.image)
    mask = _load(args.mask)
    _save(args.out, crop_to_bounding_box(vol, np.asarray(mask.data)))


def conf_extract_slices(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True, help="output prefix")
    p.add_argument("--axis", type=int, default=2, choices=(0, 1, 2))
    p.add_argument("--indices", type=int, nargs="*", default=[])
    p.add_argument("--fractions", type=float, nargs="*", default=[])
    p.add_argument("--window", type=int, default=0)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--mask", default=None,
                   help="crop to this mask's bounding box first")
    p.add_argument("--no-flip", action="store_true")


def run_extract_slices(args):
    """Reference tools/ExtractSlices.cxx."""
    from ife_tpu.ops.transform import (
        crop_to_bounding_box,
        extract_slice,
        slice_indices,
    )

    vol = _load(args.image)
    if args.mask:
        mask = _load(args.mask)
        vol = crop_to_bounding_box(vol, np.asarray(mask.data))
    n = vol.shape[args.axis]
    idxs = slice_indices(n, args.indices, args.fractions, args.window,
                         args.stride)
    if not idxs:
        raise ValueError("no slice indices selected")
    data = vol.numpy()
    from ife_tpu.core.volume import Volume

    for i in idxs:
        plane = extract_slice(data, args.axis, i, flip=not args.no_flip)
        sp = [vol.spacing[d] for d in range(3) if d != args.axis]
        out = Volume(plane[..., None], spacing=(*sp, 1.0))
        _save(f"{args.out}_{i}.nii.gz", out)


def conf_extract_window(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--level", type=float, default=-500.0)
    p.add_argument("--width", type=float, default=1500.0)
    p.add_argument("--out-spacing", type=float, default=0.25)
    p.add_argument("--mask", default=None)
    p.add_argument("-b", "--spline-order", type=int, default=3,
                   choices=range(6), metavar="[0-5]",
                   help="B-spline interpolation order "
                   "(reference ExtractWindow.cxx:43, default 3)")


def run_extract_window(args):
    """Reference tools/ExtractWindow.cxx: resample 2D to isotropic spacing
    (B-spline interpolation, ceil sizing, NN extrapolation; the mask rides
    nearest-neighbor, :230-232) then window to uint8."""
    import jax.numpy as jnp
    from ife_tpu.core.volume import Volume
    from ife_tpu.ops.transform import intensity_window, resample_to_spacing_2d

    vol = _load(args.image)
    data = np.asarray(vol.data)
    if data.ndim == 3 and data.shape[2] == 1:
        data = data[..., 0]
    if data.ndim != 2:
        raise ValueError("extract-window expects a 2D image")
    res = resample_to_spacing_2d(jnp.asarray(data), vol.spacing[:2],
                                 args.out_spacing,
                                 order=args.spline_order)
    win = intensity_window(res, args.level, args.width)
    if args.mask:
        mask = _load(args.mask)
        m = np.asarray(mask.data)
        if m.ndim == 3:
            m = m[..., 0]
        # mask rides nearest-neighbor so it stays binary (reference
        # ExtractWindow.cxx:230-232)
        mres = resample_to_spacing_2d(jnp.asarray(m.astype(np.float32)),
                                      mask.spacing[:2], args.out_spacing,
                                      order=0)
        win = jnp.where(mres > 0.5, win, 0)
    out = Volume(np.asarray(win)[..., None],
                 spacing=(args.out_spacing, args.out_spacing, 1.0))
    _save(args.out, out)


def conf_pad_image(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--size", type=_pair, required=True, metavar="X,Y")
    p.add_argument("--value", type=float, default=0.0)


def run_pad_image(args):
    """Reference tools/PadImage.cxx:60-76."""
    from ife_tpu.core.volume import Volume
    from ife_tpu.ops.transform import pad_to_size_2d

    vol = _load(args.image)
    data = np.asarray(vol.data)
    squeeze = data.ndim == 3 and data.shape[2] == 1
    if squeeze:
        data = data[..., 0]
    out = pad_to_size_2d(data, args.size, args.value)
    _save(args.out, Volume(out[..., None], spacing=vol.spacing))


def conf_resample(p):
    p.add_argument("-s", "--source", required=True)
    p.add_argument("-t", "--target", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--nearest", action="store_true",
                   help="nearest-neighbor interpolation (for masks)")
    p.add_argument("--default-value", type=float, default=0.0)


def run_resample(args):
    """Reference tools/Resample.cxx:83-103."""
    from ife_tpu.ops.transform import resample_to_grid

    src = _load(args.source)
    tgt = _load(args.target)
    out = resample_to_grid(src, tgt, order=0 if args.nearest else 1,
                           default_value=args.default_value)
    _save(args.out, out)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def conf_convert_hr2(p):
    p.add_argument("input")
    p.add_argument("output")


def run_convert_hr2(args):
    """Reference tools/ConvertHR2.cxx:23-95."""
    from ife_tpu.io import read_hr2

    _save(args.output, read_hr2(args.input))


def conf_convert_from_octave(p):
    p.add_argument("input")
    p.add_argument("output")


def run_convert_from_octave(args):
    """Reference tools/ConvertFromOctave.cxx:56-75."""
    from ife_tpu.io import read_octave

    _save(args.output, read_octave(args.input))


def conf_convert_dicom(p):
    p.description = (
        "Supported transfer syntaxes: Implicit VR LE (1.2.840.10008.1.2), "
        "Explicit VR LE (1.2.840.10008.1.2.1), RLE Lossless "
        "(1.2.840.10008.1.2.5). JPEG-family files must be transcoded first."
    )
    p.add_argument("-d", "--dicom-dir", required=True)
    p.add_argument("-o", "--out-dir", required=True)


def run_convert_dicom(args):
    """Reference tools/ConvertDICOM.cxx:70-131: one volume per series,
    named from PatientID/StudyDate/ConvolutionKernel/SliceSpacing tags."""
    from ife_tpu.io.dicom import convert_dicom_dir

    written = convert_dicom_dir(args.dicom_dir, args.out_dir)
    for path in written:
        _progress(f"wrote {path}")


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def conf_merge_bags(p):
    p.add_argument("-b", "--bags", nargs="+", required=True,
                   help="per-image .bag CSV files")
    p.add_argument("-o", "--out", required=True, help="output .npz")
    p.add_argument("--bag-labels", default=None,
                   help="CSV: one label row per bag")
    p.add_argument("--instance-labels", nargs="+", default=None,
                   help="per-bag CSVs of instance labels")


def run_merge_bags(args):
    """Fixed MakeBaggedDataset capability (reference
    tools/MakeBaggedDataset.cxx:73-149, dead code there)."""
    from ife_tpu.io.text import read_text_matrix
    from ife_tpu.roi.bagged_dataset import merge_bags, save_bagged_dataset

    bag_labels = (
        read_text_matrix(args.bag_labels) if args.bag_labels else None
    )
    if args.instance_labels and len(args.instance_labels) != len(args.bags):
        raise ValueError("need one instance-label file per bag")
    data = merge_bags(args.bags, bag_labels, args.instance_labels)
    save_bagged_dataset(args.out, data)
    _progress(
        f"wrote {data['instances'].shape[0]} instances in "
        f"{len(args.bags)} bags -> {args.out}"
    )


def conf_expected_distance(p):
    p.add_argument("-m", "--mask", required=True)
    p.add_argument("-p", "--prob", required=True,
                   help="interest-point probability image")


def run_expected_distance(args):
    """Reference tools/CalculateExpectedDistanceFromCenterToInterestPoints
    .cxx:76-79 — prints the scalar."""
    from ife_tpu.stats.distance import (
        expected_distance_from_center_to_interest_point,
    )

    mask = _load(args.mask)
    prob = _load(args.prob)
    val = expected_distance_from_center_to_interest_point(
        np.asarray(mask.data), np.asarray(prob.data), mask.spacing
    )
    print(val)


def conf_image_browser(p):
    p.add_argument("-i", "--image", required=True)
    p.add_argument("--cmd", default=None,
                   help="run one command non-interactively (info|hist|coverage)")
    p.add_argument("--roi-size", type=_triple, default=(41, 41, 41),
                   metavar="X,Y,Z")
    p.add_argument("--coverage-samples", type=int, default=1000)


def run_image_browser(args):
    """Reference tools/ImageBrowser.cxx: info, unique-value histogram, and
    Monte-Carlo ROI-coverage estimation (:24-100)."""
    vol = _load(args.image)
    data = vol.numpy()

    def cmd_info():
        print(f"shape: {vol.shape}")
        print(f"spacing: {vol.spacing}")
        print(f"origin: {vol.origin}")
        print(f"dtype: {vol.dtype}")
        print(f"min/max: {data.min():g} {data.max():g}")

    def cmd_hist():
        vals, counts = np.unique(data, return_counts=True)
        if vals.size > 64:
            print(f"{vals.size} unique values; showing 64 quantile bins")
            qs = np.quantile(data.reshape(-1), np.linspace(0, 1, 65))
            hist, _ = np.histogram(data, bins=np.unique(qs))
            for lo, hi, c in zip(qs[:-1], qs[1:], hist):
                print(f"[{lo:g}, {hi:g}): {c}")
        else:
            for v, c in zip(vals, counts):
                print(f"{v:g}: {c}")

    def cmd_coverage():
        from ife_tpu.roi import generate_random_rois

        binary = (data != 0).astype(np.uint8)
        covered = np.zeros_like(binary, dtype=bool)
        rois = generate_random_rois(binary, n=args.coverage_samples,
                                    size=args.roi_size, seed=0)
        for r in rois:
            covered[r.slices()] = True
        frac = covered[binary != 0].mean() if binary.any() else 0.0
        print(f"coverage: {frac:.4f} with {len(rois)} ROIs of {args.roi_size}")

    cmds = {"info": cmd_info, "hist": cmd_hist, "coverage": cmd_coverage}
    if args.cmd:
        cmds[args.cmd]()
        return
    print("commands: info hist coverage quit")
    for line in sys.stdin:
        c = line.strip()
        if c in ("quit", "q", "exit"):
            break
        if c in cmds:
            cmds[c]()
        elif c:
            print(f"unknown command {c!r}; commands: info hist coverage quit")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, Tuple] = {
    "extract-features": (conf_extract_features, run_extract_features,
                         "8-channel multi-scale feature volumes (ExtractFeatures)"),
    "make-bag": (conf_make_bag, run_make_bag,
                 "per-ROI feature histogram bag CSV (MakeBag)"),
    "make-bag-dense": (conf_make_bag_dense, run_make_bag_dense,
                       "bag with an ROI at every foreground voxel (MakeBagDense)"),
    "make-bag-only-intensity": (conf_make_bag_only_intensity,
                                run_make_bag_only_intensity,
                                "raw-intensity bag (MakeBagOnlyIntensity)"),
    "determine-bin-edges": (conf_determine_bin_edges, run_determine_bin_edges,
                            "equalized histogram bin edges over an image list "
                            "(DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures)"),
    "masked-normalized-convolution": (conf_masked_normalized_convolution,
                                      run_masked_normalized_convolution,
                                      "normalized Gaussian convolution (MaskedNormalizedConvolution)"),
    "gradient-features": (conf_gradient_features, run_gradient_features,
                          "masked gradient magnitude (FiniteDifference_GradientFeatures)"),
    "hessian-features": (conf_hessian_features, run_hessian_features,
                         "raw Hessian eigen-feature volumes "
                         "(FiniteDifference_HessianFeatures, fixed)"),
    "generate-rois": (conf_generate_rois, run_generate_rois,
                      "random ROI boxes from a mask (GenerateROIs)"),
    "generate-rois-many-regions": (conf_generate_rois_many_regions,
                                   run_generate_rois_many_regions,
                                   "random ROIs per mask label (GenerateROIsManyRegions)"),
    "sample-rois": (conf_sample_rois, run_sample_rois,
                    "raw voxel matrix per ROI (SampleROIs)"),
    "extract-labels": (conf_extract_labels, run_extract_labels,
                       "per-ROI mode label (ExtractLabels)"),
    "masked-image-filter": (conf_masked_image_filter, run_masked_image_filter,
                            "mask an image (MaskedImageFilter)"),
    "extract-masked-region": (conf_extract_masked_region,
                              run_extract_masked_region,
                              "relabel mask by include-set (ExtractMaskedRegion)"),
    "extract-bounding-box": (conf_extract_bounding_box, run_extract_bounding_box,
                             "crop to mask bounding box (ExtractBoundingBox)"),
    "extract-slices": (conf_extract_slices, run_extract_slices,
                       "2D slices along an axis (ExtractSlices)"),
    "extract-window": (conf_extract_window, run_extract_window,
                       "resample + intensity window to uint8 (ExtractWindow)"),
    "pad-image": (conf_pad_image, run_pad_image,
                  "centered constant pad of a 2D image (PadImage)"),
    "resample": (conf_resample, run_resample,
                 "resample source onto target grid (Resample)"),
    "convert-hr2": (conf_convert_hr2, run_convert_hr2,
                    "convert .hr2 to a standard volume (ConvertHR2)"),
    "convert-from-octave": (conf_convert_from_octave, run_convert_from_octave,
                            "convert Octave ASCII matrix (ConvertFromOctave)"),
    "convert-dicom": (conf_convert_dicom, run_convert_dicom,
                      "convert DICOM series directory (ConvertDICOM)"),
    "merge-bags": (conf_merge_bags, run_merge_bags,
                   "merge per-image bags + labels into a bagged dataset "
                   "(MakeBaggedDataset, fixed)"),
    "expected-distance": (conf_expected_distance, run_expected_distance,
                          "E[signed distance x probability] over a mask "
                          "(CalculateExpectedDistanceFromCenterToInterestPoints)"),
    "image-browser": (conf_image_browser, run_image_browser,
                      "image info / histogram / ROI coverage REPL (ImageBrowser)"),
}

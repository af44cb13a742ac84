"""Bag-of-features assembly — MakeBag / MakeBagDense / MakeBagOnlyIntensity
semantics.

Reference (tools/MakeBag.cxx:405-486): per scale, run the 8-channel feature
pass; per ROI, iterate masked voxels inserting each channel into histogram
histIdx = scale*8 + feature; write frequencies into bag row j at column
offset histIdx * histSize; reset counts after every ROI row fill (the
reference's accumulate/reset discipline, SURVEY.md §7 quirks).

Here the feature volumes are computed on device (one jitted pass per
scale); binning is vectorized searchsorted/bincount over each ROI's masked
voxels instead of a per-voxel std::lower_bound loop.
"""
from __future__ import annotations

from typing import List, Sequence

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ife_tpu.ops.features import features8_auto, NUM_FEATURES
from ife_tpu.roi.generate import ROI
from ife_tpu.stats.histogram import histogram_counts


def _check_hist_spec(hist_edges: Sequence[np.ndarray], n_expected: int) -> int:
    if len(hist_edges) != n_expected:
        raise ValueError(
            f"Number of histograms must match number of features times number "
            f"of scales: got {len(hist_edges)}, expected {n_expected}"
        )
    sizes = {len(e) + 1 for e in hist_edges}
    if len(sizes) != 1:
        raise ValueError("Histograms must have the same bin count")
    return sizes.pop()


def _roi_frequencies(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Frequencies over len(edges)+1 bins, reference bin convention.
    Empty input -> nan row (reference divides counts by a zero total)."""
    idx = np.searchsorted(edges, values, side="left")
    counts = np.bincount(idx, minlength=edges.size + 1).astype(np.float64)
    total = counts.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        return counts / total


def make_bag(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=jnp.float32,
) -> np.ndarray:
    """Bag matrix (n_rois, histSize * 8 * n_scales).

    hist_edges is ordered scale-major: index i*8+k is scale i, feature k
    (reference MakeBag.cxx:453).
    """
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    mask_np = np.clip(np.asarray(mask), 0, 1)
    bag = np.zeros((len(rois), hist_size * len(hist_edges)), dtype=np.float64)

    img_dev = jnp.asarray(image, dtype)
    mask_dev = jnp.asarray(mask_np)

    roi_masks = [mask_np[r.slices()] != 0 for r in rois]

    from ife_tpu.native_lib import histogram_channels_native

    for i, sigma in enumerate(sigmas):
        feats = np.asarray(
            features8_auto(img_dev, mask_dev, float(sigma), tuple(spacing))
        )
        edges_block = np.stack(
            [np.asarray(hist_edges[i * NUM_FEATURES + k], dtype=np.float64)
             for k in range(NUM_FEATURES)]
        )
        for j, r in enumerate(rois):
            crop = feats[r.slices()]
            inside = roi_masks[j]
            vox = crop[inside]  # (n_inside, 8)
            counts = (
                histogram_channels_native(vox, edges_block)
                if vox.dtype == np.float32 else None
            )
            col0 = i * NUM_FEATURES * hist_size
            if counts is not None:  # threaded C++ binning (MakeBag hot loop)
                total = vox.shape[0]
                with np.errstate(divide="ignore", invalid="ignore"):
                    freqs = counts.astype(np.float64) / np.float64(total)
                bag[j, col0 : col0 + NUM_FEATURES * hist_size] = freqs.reshape(-1)
            else:
                for k in range(NUM_FEATURES):
                    freqs = _roi_frequencies(vox[:, k], edges_block[k])
                    col = col0 + k * hist_size
                    bag[j, col : col + hist_size] = freqs
    return bag


@functools.partial(jax.jit, static_argnames=("size",))
def roi_feature_counts_device(
    feats: jnp.ndarray,
    mask: jnp.ndarray,
    starts: jnp.ndarray,
    edges: jnp.ndarray,
    size: tuple,
):
    """Device-side MakeBag inner loop: per-ROI masked feature histogram
    COUNTS.

    All ROIs share `size` (static), so every crop is a fixed-shape
    lax.dynamic_slice and the whole bag row block is one vmapped program —
    the device replacement for the reference's per-voxel
    std::lower_bound loop (tools/MakeBag.cxx:448-457).

    Args:
      feats: TUPLE of C (X, Y, Z) channel arrays, or one (X, Y, Z, C)
        volume. The tuple form is preferred: building the channel-last
        volume costs a transient full-volume copy.
      mask: (X, Y, Z) labels; nonzero = counted.
      starts: (N, 3) int ROI start corners.
      edges: (C, E) bin edges per channel.
      size: ROI box (sx, sy, sz).

    Returns:
      ((N, C, E+1) int32 counts, (N,) int32 masked-voxel totals).
    """
    # accept a channel-last (X, Y, Z, C) VOLUME (jnp or numpy — an
    # isinstance(jnp.ndarray) check silently mis-iterated numpy volumes
    # along axis 0 as if they were channel tuples) or a channel TUPLE
    chans = (tuple(feats[..., k] for k in range(feats.shape[-1]))
             if getattr(feats, "ndim", None) == 4 else tuple(feats))

    def one(start):
        crops = [jax.lax.dynamic_slice(ch, tuple(start), size)
                 for ch in chans]
        mcrop = jax.lax.dynamic_slice(mask, tuple(start), size)
        w = (mcrop != 0).astype(jnp.int32).reshape(-1)
        vox = jnp.stack([c.reshape(-1) for c in crops], axis=1)
        # double vmap: channels here, ROIs outside (edges batched per
        # channel); ROI crops are tiny, one compare-reduce chunk each
        counts = jax.vmap(
            lambda v, e: histogram_counts(v, e, w), in_axes=(1, 0)
        )(vox, edges)
        return counts, w.sum()

    return jax.vmap(one)(starts)


def _frequencies(counts, totals) -> np.ndarray:
    """Host-side f64 frequencies from fetched device counts — the same
    division, in the same precision, as the host bag path."""
    counts = np.asarray(counts, np.float64)
    totals = np.asarray(totals, np.float64)[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        return counts / totals


def _size_classes(rois: Sequence[ROI]):
    """ROI indices bucketed by box size: [(size, index_list), ...] in
    first-appearance order. The device paths run ONE fixed-shape vmapped
    program per class (a fixed-shape dynamic_slice under vmap needs a
    static size), so reference `.ROIInfo` files with heterogeneous boxes
    (tools/MakeBag.cxx:304-317 accepts per-ROI sizes) stay on the device
    path instead of falling back to the host path."""
    classes: dict = {}
    for j, r in enumerate(rois):
        classes.setdefault(r.size, []).append(j)
    return list(classes.items())


def _round_edges_f32(edges_block: np.ndarray, fdt) -> jnp.ndarray:
    """Edges for in-f32 binning: the bin convention compares f32 values
    against f64 edges (exact after promotion); comparing in f32 is
    equivalent iff edges are rounded DOWN (v <= e64 <=> v <= f32_floor
    (e64))."""
    if fdt == jnp.float32:
        e32 = edges_block.astype(np.float32)
        over = e32.astype(np.float64) > edges_block
        e32[over] = np.nextafter(
            e32[over], np.float32(-np.inf), dtype=np.float32
        )
        edges_block = e32
    return jnp.asarray(edges_block, fdt)


def make_bag_device(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=jnp.float32,
) -> np.ndarray:
    """make_bag with the ROI histogramming on device. Same
    (n_rois, histSize * 8 * n_scales) layout and bin semantics as
    make_bag; only one small (N, hists, bins) array returns to host per
    scale instead of the full feature volume. Mixed ROI sizes run as one
    vmapped program per size class (see _size_classes)."""
    classes = _size_classes(rois)
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    img_dev = jnp.asarray(image, dtype)
    mask_dev = jnp.asarray(np.clip(np.asarray(mask), 0, 1))
    starts_np = np.asarray([r.index for r in rois])
    bag = np.zeros((len(rois), hist_size * NUM_FEATURES * len(sigmas)),
                   dtype=np.float64)
    from ife_tpu.ops.features import features8_auto_channels

    for i, sigma in enumerate(sigmas):
        # channel TUPLE: no channel-last materialization (a 4.3 GB
        # transient at 512^3)
        feats = features8_auto_channels(
            img_dev, mask_dev, float(sigma), tuple(spacing))
        edges_block = np.stack([
            np.asarray(hist_edges[i * NUM_FEATURES + k], dtype=np.float64)
            for k in range(NUM_FEATURES)
        ])
        edges_dev = _round_edges_f32(edges_block, feats[0].dtype)
        col0 = i * NUM_FEATURES * hist_size
        for size, idxs in classes:
            freqs = _frequencies(*roi_feature_counts_device(
                feats, mask_dev, jnp.asarray(starts_np[idxs]), edges_dev,
                size,
            ))  # (n_class, 8, hist_size)
            bag[idxs, col0 : col0 + NUM_FEATURES * hist_size] = (
                freqs.reshape(len(idxs), -1))
    return bag


def make_bag_sharded(
    image: np.ndarray,
    mask: np.ndarray,
    sigmas: Sequence[float],
    hist_edges: Sequence[np.ndarray],
    rois: Sequence[ROI],
    mesh,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    dtype=jnp.float32,
) -> np.ndarray:
    """make_bag over a block-sharded mesh: feature volumes never touch the
    host. Per scale, the 8-channel pass runs sharded (halo-exchange
    parallel, parallel/features.py) and the per-ROI histograms are taken on
    device from the still-sharded feature array; only the
    (n_rois, 8, hist_size) frequency block is fetched. Same layout and bin
    semantics as make_bag / the reference's MakeBag.cxx:405-486.

    Mixed ROI sizes run as one vmapped program per size class (see
    _size_classes). Works multi-host: inputs are placed via the
    global-array path and the replicated frequency block reads
    identically on every process.
    """
    from ife_tpu.parallel.features import sharded_features8
    from ife_tpu.parallel.launcher import fetch_to_host
    from ife_tpu.parallel.mesh import pad_to_mesh, shard_volume

    classes = _size_classes(rois)
    hist_size = _check_hist_spec(hist_edges, NUM_FEATURES * len(sigmas))
    mask_np = np.clip(np.asarray(mask), 0, 1)

    # pad to the mesh grid; ROIs index the original region only, so the
    # edge-padded tail is never sliced — feature values in the kept region
    # match the single-device op exactly (pad_to_mesh composition)
    img_p, _ = pad_to_mesh(np.asarray(image, np.float32), mesh)
    msk_p, _ = pad_to_mesh(mask_np, mesh)
    img_s = shard_volume(jnp.asarray(img_p, dtype), mesh)
    msk_s = shard_volume(jnp.asarray(msk_p), mesh)
    starts_np = np.asarray([r.index for r in rois])
    bag = np.zeros((len(rois), hist_size * NUM_FEATURES * len(sigmas)),
                   dtype=np.float64)

    for i, sigma in enumerate(sigmas):
        # channel tuple: skips the channel-last relayout entirely
        feats = sharded_features8(img_s, msk_s, float(sigma), mesh,
                                  tuple(spacing), stack=False)
        edges_block = np.stack([
            np.asarray(hist_edges[i * NUM_FEATURES + k], dtype=np.float64)
            for k in range(NUM_FEATURES)
        ])
        edges_dev = _round_edges_f32(edges_block, feats[0].dtype)
        col0 = i * NUM_FEATURES * hist_size
        for size, idxs in classes:
            counts, totals = roi_feature_counts_device(
                feats, msk_s, jnp.asarray(starts_np[idxs]), edges_dev, size
            )
            freqs = _frequencies(fetch_to_host(counts), fetch_to_host(totals))
            bag[idxs, col0 : col0 + NUM_FEATURES * hist_size] = (
                freqs.reshape(len(idxs), -1))
    return bag


def make_bag_intensity(
    image: np.ndarray,
    mask: np.ndarray,
    hist_edges: np.ndarray,
    rois: Sequence[ROI],
) -> np.ndarray:
    """MakeBagOnlyIntensity semantics (tools/MakeBagOnlyIntensity.cxx:326-382):
    one histogram over RAW intensity, no features, no scales."""
    edges = np.asarray(hist_edges)
    mask_np = np.clip(np.asarray(mask), 0, 1)
    img = np.asarray(image)
    bag = np.zeros((len(rois), edges.size + 1), dtype=np.float64)
    for j, r in enumerate(rois):
        crop = img[r.slices()]
        inside = mask_np[r.slices()] != 0
        bag[j] = _roi_frequencies(crop[inside], edges)
    return bag


def sample_rois(image: np.ndarray, rois: Sequence[ROI]) -> np.ndarray:
    """SampleROIs semantics (tools/SampleROIs.cxx:104-170): one row per ROI
    of raw voxel values in ITK scan order (x fastest). ROIs must share size."""
    sizes = {r.size for r in rois}
    if len(sizes) > 1:
        raise ValueError("All ROIs must have the same size")
    rows = []
    img = np.asarray(image)
    for r in rois:
        crop = img[r.slices()]
        # ITK scan order: x fastest -> transpose to (z, y, x) then ravel C-order
        rows.append(crop.transpose(2, 1, 0).reshape(-1))
    return np.stack(rows) if rows else np.zeros((0, 0))


def extract_labels(
    label_image: np.ndarray,
    rois: Sequence[ROI],
    ignore: Sequence[int] = (),
    dominant: int | None = None,
    dominant_threshold: float = 0.0,
) -> List[int]:
    """ExtractLabels semantics (tools/ExtractLabels.cxx:165-210): per-ROI
    mode label, skipping ignore-list values; if `dominant` is given and its
    fraction exceeds `dominant_threshold`, it wins."""
    img = np.asarray(label_image)
    out = []
    ignore_set = set(int(v) for v in ignore)
    for r in rois:
        crop = img[r.slices()].reshape(-1)
        vals, counts = np.unique(crop, return_counts=True)
        keep = [
            (c, v) for v, c in zip(vals.tolist(), counts.tolist())
            if int(v) not in ignore_set
        ]
        if not keep:
            out.append(0)
            continue
        total = sum(c for c, _ in keep)
        if dominant is not None:
            dom = [(c, v) for c, v in keep if int(v) == int(dominant)]
            if dom and dom[0][0] / total > dominant_threshold:
                out.append(int(dominant))
                continue
        keep.sort(key=lambda cv: (-cv[0], cv[1]))
        out.append(int(keep[0][1]))
    return out

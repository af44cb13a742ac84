"""Region-of-interest (ROI) generation.

Reference semantics:
  * Random sampling (include/ife/ROI/RegionOfInterestGenerator.hxx:22-59):
    draw random foreground mask voxels, center a box there
    (start = center - size/2, integer division), accept only boxes fully
    inside the image, repeat until n accepted. Seeding is nondeterministic
    in the reference; parity is distributional (SURVEY.md §7 quirk 6), and
    we take an explicit seed for reproducibility.
  * Dense sweep (include/ife/ROI/DenseROIGenerator.hxx:21-47): EVERY
    foreground voxel becomes a center; keep fully-inside boxes.

Vectorized: instead of ITK's accept/reject iterator loop, foreground
indices are materialized once and the center->box->inside test is a single
vectorized filter; random generation draws batches without replacement
pressure (sampling WITH replacement across batches, like the reference's
re-running random iterator).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ROI:
    """An axis-aligned box: start index + size, ITK Region semantics."""

    index: Tuple[int, int, int]
    size: Tuple[int, int, int]

    def slices(self):
        return tuple(slice(i, i + s) for i, s in zip(self.index, self.size))

    def __str__(self) -> str:
        # ITK's Index/Size operator<< format, written by the reference at
        # tools/MakeBag.cxx:290-292 and parsed by ROIReader.hxx:26-50.
        i, s = self.index, self.size
        return f"[{i[0]}, {i[1]}, {i[2]}][{s[0]}, {s[1]}, {s[2]}]"


def _candidate_boxes(centers: np.ndarray, size, shape) -> np.ndarray:
    """centers (N,3) -> accept mask of boxes fully inside `shape`."""
    size = np.asarray(size, dtype=np.int64)
    start = centers - size // 2
    ok = np.all(start >= 0, axis=1) & np.all(
        start + size <= np.asarray(shape, dtype=np.int64), axis=1
    )
    return start, ok


def generate_random_rois(
    mask: np.ndarray,
    n: int,
    size: Sequence[int],
    seed: int | None = None,
    max_draw_factor: int = 1000,
) -> List[ROI]:
    """Sample n ROIs centered at random foreground voxels, boxes fully
    inside the image. Raises if the mask has no valid centers."""
    m = np.asarray(mask)
    fg = np.argwhere(m != 0)
    if fg.shape[0] == 0:
        raise ValueError("mask has no foreground voxels")
    rng = np.random.default_rng(seed)
    rois: List[ROI] = []
    draws = 0
    batch = max(4 * n, 64)
    while len(rois) < n:
        if draws > max_draw_factor * max(n, 1) + batch:
            raise RuntimeError(
                "could not place requested ROIs inside the image "
                "(mask too close to the border for this box size?)"
            )
        sel = rng.integers(0, fg.shape[0], size=batch)
        centers = fg[sel]
        start, ok = _candidate_boxes(centers, size, m.shape)
        for st in start[ok]:
            rois.append(ROI(tuple(int(x) for x in st), tuple(int(x) for x in size)))
            if len(rois) == n:
                break
        draws += batch
    return rois


def generate_dense_rois(mask: np.ndarray, size: Sequence[int]) -> List[ROI]:
    """Every foreground voxel is a center; keep fully-inside boxes.
    Scan order matches ITK's region iterator (x fastest)."""
    m = np.asarray(mask)
    fg = np.argwhere(m != 0)  # argwhere iterates last axis fastest; reorder below
    if fg.shape[0] == 0:
        return []
    # ITK iterates x fastest, then y, then z: sort by (z, y, x)
    order = np.lexsort((fg[:, 0], fg[:, 1], fg[:, 2]))
    fg = fg[order]
    start, ok = _candidate_boxes(fg, size, m.shape)
    return [
        ROI(tuple(int(x) for x in st), tuple(int(x) for x in size))
        for st in start[ok]
    ]

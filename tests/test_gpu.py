"""Checks that need an NVIDIA GPU: the f32 feature path and the histograms
compiled for the card, against the f64 NumPy reference. They skip
elsewhere; on a machine with a card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

(chip_smoke.py runs the same comparisons at full width).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ife_tpu.ops.features import features8_auto
from ife_tpu.stats.histogram import histogram_counts
from gpu_verify import (
    BUDGET, check_within, count_mismatch, feature_errors, gate_scan,
    numpy_reference, searchsorted_counts,
)

pytestmark = pytest.mark.gpu

SPACING = (0.78, 0.78, 1.0)


@pytest.mark.parametrize("sigma", (0.6, 1.2, 2.4, 4.8))
def test_features8_f32_on_gpu_within_budget(gpu, sigma):
    img, msk = gate_scan((72, 68, 61), seed=5)
    got = features8_auto(jax.device_put(img, gpu), jax.device_put(msk, gpu),
                         sigma, SPACING)
    assert got.dtype == jnp.float32
    assert got.devices() == {gpu}
    want = numpy_reference().features8_np(img.astype(np.float64), msk,
                                          sigma, SPACING)
    check_within(f"gpu s={sigma}", feature_errors(np.asarray(got), want),
                 BUDGET)


def test_histogram_counts_exact_on_gpu(gpu):
    img, msk = gate_scan((72, 68, 61), seed=6)
    edges = np.linspace(-1100.0, -100.0, 31).astype(np.float32)
    got = histogram_counts(jax.device_put(img, gpu),
                           jax.device_put(edges, gpu),
                           jax.device_put((msk != 0).astype(np.int32), gpu))
    assert count_mismatch(got, searchsorted_counts(img[msk != 0], edges)) == 0

"""Benchmark: Hessian + closed-form eigen features, voxels/sec/chip.

The BASELINE.json metric ("Hessian+eig voxels/sec/chip at 512^3"). The
reference publishes no numbers (BASELINE.md), so vs_baseline is measured
against a PINNED NumPy re-derivation of the same pipeline on the host CPU
(BASELINE_CPU.json — the single-node stand-in for the reference's ITK
implementation; pinned so the multiplier does not swing with host load).

    python bench.py            # 512^3 timing + the on-device verify block
    python bench.py --verify   # the verify block only
    python bench.py --all      # BASELINE.md configs 1-4 at their sizes

Runs on an NVIDIA GPU only: on any other device it raises. Every result
names the device (`device_kind`, count) and the card's name and power
limit from nvidia-smi. Prints exactly one JSON line.
"""
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASELINE_FILE = os.path.join(_HERE, "BASELINE_CPU.json")
SPACING = (0.78, 0.78, 1.0)


def _setup():
    """nvidia-smi (read before JAX touches the card), the compile cache,
    and the GPU devices — raising if there are none."""
    sys.path.insert(0, _HERE)
    from gpu_verify import read_nvidia_smi, require_gpu

    smi = read_nvidia_smi()
    import jax

    from ife_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = require_gpu(jax.devices())
    return {"device_kind": devices[0].device_kind, "count": len(devices),
            "platform": devices[0].platform, "nvidia_smi": smi}


def _loop_time(fn, x, *rest, inner=32, reps=5):
    """(best, median, worst) seconds per pass: `inner` serial passes inside
    ONE jit, each consuming the previous output, so XLA can neither hoist
    a pass out of the loop nor overlap two of them; the timing ends in
    block_until_ready. `rest` are constant jit parameters (big device
    arrays are passed, never closed over)."""
    import jax

    shape = x.shape

    @jax.jit
    def loop(v, *r):
        def body(_, c):
            out = fn(c, *r)
            return out if out.shape == shape else out[..., 0]
        return jax.lax.fori_loop(0, inner, body, v)

    loop(x, *rest).block_until_ready()  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        loop(x, *rest).block_until_ready()
        ts.append((time.perf_counter() - t0) / inner)
    ts.sort()
    return ts[0], ts[len(ts) // 2], ts[-1]


def bench_hessian_eig(shape, inner=32, reps=5):
    """(best, median, worst) voxels/sec of Hessian + eigen features."""
    import jax
    import jax.numpy as jnp

    from ife_tpu.ops.features import hessian_eig_features

    x = jax.random.normal(jax.random.PRNGKey(0), shape, dtype=jnp.float32)

    def one_pass(v):
        return hessian_eig_features(v, SPACING)[..., 0]

    best, med, worst = _loop_time(one_pass, x, inner=inner, reps=reps)
    n = float(np.prod(shape))
    return n / best, n / med, n / worst


def cpu_baseline_voxels_per_sec():
    """Pinned host-NumPy re-derivation throughput (BASELINE_CPU.json)."""
    with open(_BASELINE_FILE) as f:
        return float(json.load(f)["voxels_per_sec"])


def bench_all():
    """BASELINE.md configs 1-4, each at its stated size."""
    import jax
    import jax.numpy as jnp

    from ife_tpu.ops.eigen import eigenvalue_features
    from ife_tpu.ops.features import (
        features8_auto_channels, hessian_eig_features,
    )
    from ife_tpu.stats.histogram import histogram_counts

    key = jax.random.PRNGKey(0)
    detail = {}

    # config 1: eigen solver on a synthetic 64^3 Hessian field; channel 0
    # fed back as all six inputs for the serial dependence
    H = jax.random.normal(key, (64, 64, 64, 6), jnp.float32)
    _, dt, _ = _loop_time(lambda h: jnp.broadcast_to(
        eigenvalue_features(h)[..., :1], h.shape), H, inner=64)
    detail["config1_eigen_64cubed_voxels_per_sec"] = 64 ** 3 / dt

    # config 2: single-scale Hessian features + eigen, 128^3
    x128 = jax.random.normal(key, (128, 128, 128), jnp.float32)
    _, dt, _ = _loop_time(
        lambda v: hessian_eig_features(v, SPACING)[..., 0], x128)
    detail["config2_hessian_eig_128cubed_voxels_per_sec"] = 128 ** 3 / dt

    def volume(shape, k):
        v = jax.random.normal(key, shape, jnp.float32) * 200.0 - 600.0
        m = (jax.random.uniform(jax.random.PRNGKey(k), shape) > 0.25
             ).astype(jnp.float32)
        return v, m

    # config 3: multi-scale (4 sigma) features8, 256^3
    scales = (0.6, 1.2, 2.4, 4.8)
    x256, m256 = volume((256, 256, 256), 1)

    def multi(v, m):
        outs = [features8_auto_channels(v, m, s, SPACING)[0] for s in scales]
        return jnp.stack(outs, 0).sum(0)

    _, dt, _ = _loop_time(multi, x256, m256, inner=12)
    detail["config3_multiscale4_features8_256cubed_voxels_per_sec"] = (
        256 ** 3 * len(scales) / dt)

    # config 4: features8 + nine masked 31-edge histograms at 512^3
    x512, m512 = volume((512, 512, 512), 2)
    edges = jnp.linspace(-1200.0, 600.0, 31)
    _, dt_feat, _ = _loop_time(
        lambda v, m: features8_auto_channels(v, m, 1.0, SPACING)[0],
        x512, m512, inner=12)
    chans = features8_auto_channels(x512, m512, 1.0, SPACING)
    w512 = m512.astype(jnp.int32)

    def hist9(v, w, e, *cs):
        # the carried value enters through the edges (f32 * 0 of a carried
        # value cannot be folded), so no histogram is loop-invariant
        e_t = e + v.reshape(-1)[0] * jnp.asarray(0.0, v.dtype)
        counts = jnp.stack([histogram_counts(c, e_t, w) for c in cs]
                           + [histogram_counts(v, e_t, w)])
        return v + counts.sum().astype(v.dtype) * jnp.asarray(0.0, v.dtype)

    _, dt_hist, _ = _loop_time(hist9, chans[0], w512, edges, *chans[1:],
                               inner=12)
    detail["config4_feat_ms"] = dt_feat * 1e3
    detail["config4_hist_ms"] = dt_hist * 1e3
    detail["config4_features_plus_hist_512cubed_voxels_per_sec"] = (
        512 ** 3 / (dt_feat + dt_hist))
    return detail


def main():
    device = _setup()
    from gpu_verify import verify_on_device

    def log(msg):
        print(msg, file=sys.stderr)

    if "--verify" in sys.argv:
        report = verify_on_device(full_shape=(512, 512, 512), log=log)
        print(json.dumps({"verify": "ok", "device": device, **report}))
        return
    if "--all" in sys.argv:
        print(json.dumps({"device": device, **bench_all()}))
        return
    shape = (512, 512, 512)
    best, med, worst = bench_hessian_eig(shape)
    result = {
        "metric": "hessian_eig_voxels_per_sec_chip_512cubed",
        "value": med,
        "unit": "voxels/sec/chip",
        "vs_baseline": med / cpu_baseline_voxels_per_sec(),
        "baseline": "pinned",
        "spread": {"best": best, "worst": worst, "reps": 5},
        "device": device,
        "verify": verify_on_device(full_shape=shape, log=log),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""Every f32 convolution and matrix product on the feature path must carry
Precision.HIGHEST. On a GPU an f32 conv or dot may otherwise run in TF32
(a 10-bit mantissa, ~1e-3 relative), far outside the 1e-4 budget that the
f32 features are held to against the f64 reference. The rule is checked
on the jaxprs, so it holds whatever device runs them.

Exempt: the fine histogram's one-hot dot (stats.histogram
.uniform_histogram_counts). Its operands are 0/1 values in bf16 and it
accumulates in f32, which is exact, so no precision setting applies to
it; the test below pins that its operands are bf16, not f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from ife_tpu.ops.features import features8, features8_auto_channels
from ife_tpu.ops.stencil import normalized_gaussian_convolution
from ife_tpu.stats.histogram import uniform_histogram_counts

CONTRACTIONS = ("conv_general_dilated", "dot_general")
SPACING = (0.78, 0.78, 2.5)


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _eqns(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _eqns(sub)


def contractions(fn, *args):
    """(primitive, operand dtypes, precision) of every conv/dot in fn."""
    closed = jax.make_jaxpr(fn)(*args)
    return [(e.primitive.name, tuple(v.aval.dtype for v in e.invars),
             e.params.get("precision"))
            for e in _eqns(closed.jaxpr) if e.primitive.name in CONTRACTIONS]


def f32_violations(found):
    bad = []
    for name, dtypes, prec in found:
        if jnp.float32 not in dtypes:
            continue
        precs = prec if isinstance(prec, (tuple, list)) else (prec,)
        if not all(p == jax.lax.Precision.HIGHEST for p in precs):
            bad.append((name, dtypes, prec))
    return bad


def _inputs(shape=(12, 10, 9)):
    img = jnp.asarray(np.random.default_rng(0).standard_normal(shape),
                      jnp.float32)
    return img, (img > 0).astype(jnp.float32)


@pytest.mark.parametrize("name,fn", [
    ("features8", lambda x, m: features8(x, m, 1.2, SPACING)),
    ("normalized_gaussian_convolution",
     lambda x, m: normalized_gaussian_convolution(x, m, 2.4, SPACING)),
    ("features8_auto_channels (jitted, nested jaxpr)",
     lambda x, m: features8_auto_channels(x, m, 0.6, SPACING)),
])
def test_f32_contractions_are_highest(name, fn):
    found = contractions(fn, *_inputs())
    assert found, f"{name}: expected convolutions in the jaxpr"
    assert f32_violations(found) == [], name


def test_walker_flags_default_precision():
    """The check has teeth: an f32 conv at DEFAULT precision is caught."""
    def tf32_prone(x):
        return jax.lax.conv_general_dilated(
            x[None, None], jnp.ones((1, 1, 3), jnp.float32), (1,), "VALID")

    x = jnp.ones((16,), jnp.float32)
    assert f32_violations(contractions(tf32_prone, x))


def test_fine_histogram_dot_is_bf16_onehot():
    v = jnp.linspace(-1.0, 1.0, 1000, dtype=jnp.float32)
    w = jnp.ones((1000,), jnp.int32)
    found = contractions(
        lambda v, w: uniform_histogram_counts(
            v, w, jnp.float32(-64), jnp.float32(2.0 ** -5), 128), v, w)
    dots = [f for f in found if f[0] == "dot_general"]
    assert dots
    for _, dtypes, _ in dots:
        assert dtypes == (jnp.bfloat16, jnp.bfloat16)

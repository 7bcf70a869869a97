"""The Image integration (``repro_torch.core.annotated_image``) against the
JAX package's, on the CPU.

The same numpy-seeded float32 images through both packages' annotated
image library, on every port executor against the reference's executor of
the same name (``pallas`` for ``cuda``) and its ``eager``, with
``tests/test_torch_table.py``'s harness: plan, counters and rewrite
records exact, ``cuda_fallback_stages`` equal to the stage count (no image
op is elementwise-annotated, so neither package's kernel lowering takes
one), values and dtypes.  Tolerances: float32 rtol 2e-5 with atol 1e-6 *
max|reference| (``TOL`` f32 of ``tests/test_kernels.py`` for the direct
function comparisons); histogram counts exactly, edge values included.

Ported: ``tests/test_integrations.py::TestImage``, the image surface of
``tests/test_differential.py``, and fig4's nashville and gotham filters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import workloads as jw
from repro.core import annotated_image as jimg
from repro_torch import workloads as tw
from repro_torch.core import annotated_image as timg
from repro_torch.core import plan_cache as tplan_cache
from repro_torch.core.annotation import AnnotatedFn
from test_torch_table import EXECUTORS, check_pair, same_values, to_np

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    tplan_cache.clear()
    yield


def _image(h=32, w=16, seed=0):
    a = np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


# ---------------------------------------------------------------------------
# tests/test_integrations.py::TestImage
# ---------------------------------------------------------------------------


def test_hsv_roundtrip_and_conversions_match_jax():
    im, jim = _image()
    hsv = timg._rgb_to_hsv(im)
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jimg._rgb_to_hsv(jim)), **TOL)
    np.testing.assert_allclose(timg._hsv_to_rgb(hsv).numpy(),
                               np.asarray(jimg._hsv_to_rgb(jnp.asarray(hsv.numpy()))), **TOL)
    np.testing.assert_allclose(timg._hsv_to_rgb(hsv).numpy(), im.numpy(), atol=1e-5)


def test_hsv_sectors_and_gray_pixels():
    """One pixel in each of the six hue sectors (r, g or b largest, each
    way round), gray and black pixels (d == 0, mx == 0), and a hue past
    1.0 folded by the floor modulo."""
    px = np.array([[0.9, 0.3, 0.1], [0.5, 0.8, 0.2], [0.1, 0.7, 0.6], [0.2, 0.3, 0.9],
                   [0.6, 0.1, 0.8], [0.9, 0.1, 0.4], [0.5, 0.5, 0.5], [0.0, 0.0, 0.0],
                   [1.0, 1.0, 1.0]], np.float32)[None]
    hsv = timg._rgb_to_hsv(torch.from_numpy(px))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jimg._rgb_to_hsv(jnp.asarray(px))),
                               **TOL)
    shifted = hsv.numpy().copy()
    shifted[..., 0] = shifted[..., 0] * 1.7 - 0.35        # negative and past-1 hues
    np.testing.assert_allclose(timg._hsv_to_rgb(torch.from_numpy(shifted)).numpy(),
                               np.asarray(jimg._hsv_to_rgb(jnp.asarray(shifted))), **TOL)


def _filter(img):
    def pipe(im):
        a = img.colortone(im, (0.2, 0.2, 0.6), 0.3, True)
        b = img.gamma(a, 1.2)
        c = img.modulate(b, 110.0, 140.0, 100.0)
        return img.contrast(c, 1.1)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_filter_pipeline_matches_eager(executor):
    im, jim = _image(h=40)
    _, ctx = check_pair(_filter(timg), (im,), _filter(jimg), (jim,), executor, 7)
    assert ctx.stats["stages"] == 1                   # whole filter = 1 stage


def _hist(img):
    def pipe(im):
        return img.brightness_histogram(im)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
def test_histogram_reduction(executor):
    im, jim = _image(h=64)
    (h,), _ = check_pair(_hist(timg), (im,), _hist(jimg), (jim,), executor, 5)
    assert h.dtype == np.float32 and int(h.sum()) == 64 * 16


def test_histogram_bins_edge_values_as_jnp():
    """Values on every edge (an inner edge counts in the upper bin, 1.0 in
    the last), one ulp either side of each, just outside [0, 1], -0.0 and
    nan, against ``jnp.histogram(x, bins=16, range=(0, 1))``.  No
    subnormals: XLA's CPU backend flushes them to zero, the card does not."""
    edges = np.arange(17, dtype=np.float32) / 16
    near = np.concatenate([np.nextafter(edges[1:], np.float32(-1)),
                           np.nextafter(edges[1:], np.float32(2))])
    x = np.concatenate([edges, near, np.array([-1e-7, 1e-7, -0.0, -1.0, 2.0, np.nan],
                                              np.float32)]).astype(np.float32)
    assert not np.any((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    want = np.asarray(jnp.histogram(jnp.asarray(x), bins=16, range=(0.0, 1.0))[0])
    got = timg._histogram(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.float32


def test_histogram_of_gray_levels_on_the_edges():
    """Gray pixels (v, v, v) at v = k/16: luminance on (or one ulp off)
    each edge, binned as the reference bins it."""
    v = np.repeat(np.arange(17, dtype=np.float32) / 16, 3).reshape(17, 1, 3)
    im = np.ascontiguousarray(np.broadcast_to(v, (17, 4, 3)))
    want = np.asarray(jimg._brightness_histogram(jnp.asarray(im)))
    np.testing.assert_array_equal(timg._brightness_histogram(torch.from_numpy(im)).numpy(),
                                  want)


def test_blur_not_annotated_and_matches_jax():
    assert not isinstance(timg.blur, AnnotatedFn)
    im, jim = _image(h=11, w=9)
    for radius in (1, 2):
        out = timg.blur(im, radius=radius)
        assert out.shape == im.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(jimg.blur(jim, radius=radius)),
                                   **TOL)


# ---------------------------------------------------------------------------
# tests/test_differential.py's image surface; fig4's filters
# ---------------------------------------------------------------------------

SIZES = [0, 1, 7, 257]


def _surface(img):
    def pipe(im):
        a = img.colortone(im, (0.2, 0.1, 0.0), 0.4, True)
        b = img.gamma(a, 1.8)
        c = img.contrast(b, 1.3)
        d = img.screen_blend(c, c)
        return d, img.brightness_histogram(d)
    return pipe


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("h", SIZES)
def test_image_surface(executor, h):
    a = np.random.RandomState(h + 2).rand(h, 12, 3).astype(np.float32)
    check_pair(_surface(timg), (torch.from_numpy(a),), _surface(jimg), (jnp.asarray(a),),
               executor, 32)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("name", ["nashville", "gotham"])
def test_fig4_filters_match_jax(name, executor):
    """fig4's image (``workloads.image``: the reference's draws) at 70 x 9
    in bands of 16 rows; ``level``'s Python-scalar bounds and both
    colortones."""
    im = tw.image(70, 9, device="cpu")
    (out,), ctx = check_pair(getattr(tw, name), (im,), getattr(jw, name),
                             (jnp.asarray(im.numpy()),), executor, 16)
    assert ctx.stats["stages"] == 1 and out.dtype == np.float32


def test_ops_and_probe_examples_match_the_reference():
    assert set(timg.__all_ops__) == set(jimg.__all_ops__)
    texs, jexs = timg.__probe_examples__(device="cpu"), jimg.__probe_examples__()
    assert set(texs) == set(jexs)
    for name, jkw in jexs.items():
        fn, jfn = timg.__all_ops__[name], jimg.__all_ops__[name]
        assert fn.name == jfn.name and fn.sa.static == jfn.sa.static
        same_values(to_np(fn(**texs[name])), to_np(jfn(**jkw)), name)

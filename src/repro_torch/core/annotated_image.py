"""The "ImageMagick" integration (paper §7): row-split image operators,
over torch.

The counterpart of ``src/repro/core/annotated_image.py``.  Images are
(H, W, 3) float32 tensors in [0, 1].  The split type is the paper's
MagickWand row split: pieces are horizontal bands (crops), and the merge
stacks bands back together, which is exactly ``ArraySplit(axis=0)``.

Like the paper we leave boundary-coupled operators (``blur``) un-annotated:
a blur over a band differs from a blur over the full image at band edges,
violating the SA condition F(a) = Merge(F(a1), F(a2), ...) (§3.4 / §7.1).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core import split_types as st
from repro_torch.core.annotation import annotate

__all_ops__: dict[str, object] = {}

#: ``brightness_histogram``'s bins over [0, 1].
BINS = 16


def _reg(name, fn):
    __all_ops__[name] = fn
    globals()[name] = fn
    return fn


def _select(conds, vals):
    """``jnp.select``: the value of the first condition that holds, else 0."""
    out = torch.zeros_like(vals[0])
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = torch.amax(img, dim=-1)
    mn = torch.amin(img, dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, 1.0, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = torch.where(d == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, d / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)          # floor modulo, as jnp's %
    conds = [i == k for k in range(6)]
    r = _select(conds, [v, q, p, p, t, v])
    g = _select(conds, [t, v, v, q, p, p])
    b = _select(conds, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _luminance(img):
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _at_least(x, lo: float):
    """``jnp.maximum(x, lo)`` for a Python scalar or a tensor ``x``."""
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) else max(x, lo)


# -- annotated operators (all row-splittable) --------------------------------

def _colortone(img, color, level, negate):
    """Blend a solid color weighted by (optionally negated) luminance."""
    lum = _luminance(img)
    mask = 1.0 - lum if negate else lum
    alpha = (mask * level)[..., None]
    c = torch.tensor(color, dtype=img.dtype, device=img.device)
    return torch.clamp(img * (1 - alpha) + c * alpha, 0.0, 1.0)


_reg("colortone", annotate(
    _colortone, name="colortone", static=("color", "level", "negate"),
    img=st.Generic("S"), ret=st.Generic("S")))


def _gamma(img, g):
    return torch.clamp(torch.pow(torch.clamp(img, min=1e-6), 1.0 / g), 0.0, 1.0)


_reg("gamma", annotate(_gamma, name="gamma", img=st.Generic("S"),
                       g=st._, ret=st.Generic("S")))


def _modulate(img, brightness, saturation, hue):
    """ImageMagick -modulate (percentages, 100 = unchanged)."""
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + (hue - 100.0) / 200.0, 1.0)
    s = torch.clamp(hsv[..., 1] * (saturation / 100.0), 0.0, 1.0)
    v = torch.clamp(hsv[..., 2] * (brightness / 100.0), 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


_reg("modulate", annotate(
    _modulate, name="modulate",
    img=st.Generic("S"), brightness=st._, saturation=st._, hue=st._,
    ret=st.Generic("S")))


def _contrast(img, amount):
    """Sigmoidal-ish contrast about mid-gray."""
    return torch.clamp(0.5 + (img - 0.5) * amount, 0.0, 1.0)


_reg("contrast", annotate(_contrast, name="contrast", img=st.Generic("S"),
                          amount=st._, ret=st.Generic("S")))


def _level(img, black, white):
    return torch.clamp((img - black) / _at_least(white - black, 1e-6), 0.0, 1.0)


_reg("level", annotate(_level, name="level", img=st.Generic("S"),
                       black=st._, white=st._, ret=st.Generic("S")))


def _screen_blend(img, other):
    return 1.0 - (1.0 - img) * (1.0 - other)


_reg("screen_blend", annotate(
    _screen_blend, name="screen_blend",
    img=st.Generic("S"), other=st.Generic("S"), ret=st.Generic("S")))


def _histogram(x):
    """``jnp.histogram(x, bins=16, range=(0, 1))[0]``: float32 counts; a
    value on an inner edge counts in the upper bin, 1.0 in the last one,
    values outside [0, 1] (and nan) nowhere."""
    x = x.reshape(-1)
    edges = torch.linspace(0.0, 1.0, BINS + 1, dtype=x.dtype, device=x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], BINS, idx)
    # slot 0: below the range, slot BINS + 1: above it (or nan); both dropped
    counts = torch.zeros(BINS + 2, dtype=torch.float32, device=x.device)
    return counts.index_add_(0, idx, torch.ones_like(x, dtype=torch.float32))[1:BINS + 1]


def _brightness_histogram(img):
    return _histogram(_luminance(img))


_reg("brightness_histogram", annotate(
    _brightness_histogram, name="brightness_histogram",
    img=st.Generic("S"), ret=st.Reduce("add")))


# -- deliberately UN-annotated: boundary-coupled (paper §7.1) ------------------

def blur(img, radius: int = 2):
    """Box blur, each channel on its own ("SAME" zero padding).  NOT
    annotatable: band edges differ from full-image edges."""
    k = 2 * radius + 1
    kern = torch.full((3, 1, k, k), 1.0 / (k * k), dtype=img.dtype, device=img.device)
    out = F.conv2d(img.permute(2, 0, 1)[None], kern, padding="same", groups=3)
    return out[0].permute(1, 2, 0)


def __probe_examples__(n: int = 12, device: torch.device | str = "cuda") -> dict[str, Any]:
    """Tiny concrete inputs per op for the annotation contract checker."""
    img = (torch.arange(n * 5 * 3, dtype=torch.float32, device=device).reshape(n, 5, 3)
           / float(n * 5 * 3))
    return {
        "colortone": {"img": img, "color": (0.2, 0.3, 0.5), "level": 0.5,
                      "negate": True},
        "gamma": {"img": img, "g": 2.2},
        "modulate": {"img": img, "brightness": 120.0, "saturation": 80.0,
                     "hue": 110.0},
        "contrast": {"img": img, "amount": 1.5},
        "level": {"img": img, "black": 0.1, "white": 0.9},
        "screen_blend": {"img": img, "other": 1.0 - img},
        "brightness_histogram": {"img": img},
    }

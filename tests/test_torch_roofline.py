"""The port's model-side tools without a mesh, held against the JAX package:
``configs/shapes.py`` (``SHAPES``, ``applicable``, ``enc_len_for``,
``input_specs``), ``models/config.active_param_count`` and the analytic half
of ``launch/roofline.py`` (``moe_flops_per_device``,
``recurrent_flops_per_device``, ``attention_score_bytes_per_device``,
``model_flops``, ``extrapolate``, ``roofline_terms``, ``analyze_cell``).

Every registry arch x every shape, on each package's own config of the
arch.  The reference's roofline reads its module-level ``CHIP``; it is
monkeypatched to the port's H100 constants, which the port receives as its
``chip`` argument, so both compute on the same chip.  ``analyze_cell`` runs
on synthetic dry-run records (plain dicts with the reference's keys).
Equal within float64 rounding (rel 1e-12).  Importing the reference's
roofline writes ``XLA_FLAGS`` into the environment (512 placeholder
devices for its dry runs); the import here restores the variable, so no
later test or subprocess inherits it.  The port's modules import no JAX and
set no environment variable (checked in a fresh interpreter).
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.configs.registry import ARCH_IDS, get_config as jget
from repro.models import config as jconfig
from repro_torch import hardware
from repro_torch.configs import shapes
from repro_torch.configs.registry import get_config as tget
from repro_torch.launch import roofline
from repro_torch.models import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


def _import_reference_roofline():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import roofline as jroofline
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jroofline


jroofline = _import_reference_roofline()
H100_AS_REF = SimpleNamespace(**{k: getattr(hardware.H100, k) for k in (
    "peak_bf16_flops", "hbm_bandwidth", "ici_links", "ici_link_bandwidth")})
SHAPE_NAMES = tuple(jshapes.SHAPES)
DEVICES = (1, 8, 512)


@pytest.fixture
def same_chip(monkeypatch):
    monkeypatch.setattr(jroofline, "CHIP", H100_AS_REF)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shapes_table_equals_the_reference():
    assert tuple(shapes.SHAPES) == SHAPE_NAMES
    for name, spec in shapes.SHAPES.items():
        ref = jshapes.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq_len, spec.global_batch) == \
            (ref.name, ref.kind, ref.seq_len, ref.global_batch)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_and_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = tget(arch), jget(arch)
    spec, jspec = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert shapes.applicable(cfg, spec) == jshapes.applicable(jcfg, jspec)
    assert shapes.enc_len_for(cfg, spec) == jshapes.enc_len_for(jcfg, jspec)
    got, want = shapes.input_specs(cfg, spec), jshapes.input_specs(jcfg, jspec)
    assert list(got) == list(want)
    for k, t in got.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _dtype_name(t.dtype) == str(np.dtype(want[k].dtype)), k


def test_shape_applicability_table():
    """``tests/test_arch_smoke.py::test_shape_applicability_table`` on the
    port's registry."""
    runs_500k = {a for a in ARCH_IDS
                 if shapes.applicable(tget(a), shapes.SHAPES["long_500k"])[0]}
    assert runs_500k == {"gemma3-4b", "hymba-1.5b", "rwkv6-1.6b"}
    for a in ARCH_IDS:                      # all archs decode
        assert shapes.applicable(tget(a), shapes.SHAPES["decode_32k"])[0]
    ok, why = shapes.applicable(tget("gemma-7b"), shapes.SHAPES["long_500k"])
    assert not ok and why == jshapes.applicable(jget("gemma-7b"),
                                                jshapes.SHAPES["long_500k"])[1]


def test_an_encoder_only_arch_has_no_decode_shape():
    for mod, get in ((shapes, tget), (jshapes, jget)):
        import dataclasses
        cfg = dataclasses.replace(get("gemma-7b"), decode_supported=False)
        assert mod.applicable(cfg, mod.SHAPES["decode_32k"]) == \
            (False, "encoder-only arch has no decode step")
        assert mod.applicable(cfg, mod.SHAPES["train_4k"]) == (True, "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count_equals_the_reference(arch):
    cfg, jcfg = tget(arch), jget(arch)
    assert tconfig.active_param_count(cfg) == jconfig.active_param_count(jcfg)
    assert tconfig.param_count(cfg) == jconfig.param_count(jcfg)
    if cfg.moe is None:
        assert tconfig.active_param_count(cfg) == tconfig.param_count(cfg)
    else:
        assert tconfig.active_param_count(cfg) < tconfig.param_count(cfg)


ANALYTIC = ("moe_flops_per_device", "recurrent_flops_per_device",
            "attention_score_bytes_per_device", "model_flops")


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch, shape):
    cfg, jcfg = tget(arch), jget(arch)
    spec, jspec = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    for fn in ANALYTIC:
        for n_dev in DEVICES:
            got = getattr(roofline, fn)(cfg, spec, n_dev)
            want = getattr(jroofline, fn)(jcfg, jspec, n_dev)
            assert got == pytest.approx(want, rel=1e-12, abs=0.0), (fn, n_dev)


def _records(seed: int):
    """Synthetic dry-run records: a production record and two cost variants
    at 2 and 3 layers whose collective ops overlap in part."""
    r = np.random.RandomState(seed)
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

    def variant(n):
        coll = {op: float(r.uniform(1e6, 1e9)) * n for op in ops[:3 + (n == 3)]}
        return {"status": "ok", "flops": float(r.uniform(1e12, 1e15)) * n,
                "hlo_bytes": float(r.uniform(1e9, 1e12)) * n,
                "collective": {"bytes_by_op": coll}}
    real = {"status": "ok", "n_devices": int(r.choice([1, 8, 256, 512])),
            "mesh": {"data": 16, "model": 32}, "memory": {"peak_bytes": int(r.uniform(1e9, 9e10))},
            "params": int(r.uniform(1e9, 3e10)), "active_params": int(r.uniform(1e9, 3e10))}
    return real, variant(2), variant(3)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_cell_equals_the_reference(same_chip, arch, shape):
    seed = ARCH_IDS.index(arch) * 10 + SHAPE_NAMES.index(shape)
    real, rec0, rec1 = _records(seed)
    got = roofline.analyze_cell(arch, shape, real, rec0, rec1, chip=hardware.H100)
    want = jroofline.analyze_cell(arch, shape, real, rec0, rec1)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k
        elif isinstance(v, dict) and k == "collective_by_op":
            assert set(got[k]) == set(v)
            for op, b in v.items():
                assert got[k][op] == pytest.approx(b, rel=1e-12, abs=0.0), op
        else:
            assert got[k] == v, k


def test_extrapolate_and_terms_equal_the_reference(same_chip):
    real, rec0, rec1 = _records(7)
    for n0, n1, L in ((2, 3, 28), (1, 4, 61), (2, 3, 2)):
        got = roofline.extrapolate(rec0, rec1, n0, n1, L)
        want = jroofline.extrapolate(rec0, rec1, n0, n1, L)
        by_op = got.pop("collective_bytes_by_op")
        assert by_op == pytest.approx(want.pop("collective_bytes_by_op"), rel=1e-12)
        assert got == pytest.approx(want, rel=1e-12)
        assert all(v >= 0.0 for v in by_op.values())
    terms = roofline.roofline_terms(1e15, 3e12, 1e9, hardware.H100)
    assert terms == pytest.approx(jroofline.roofline_terms(1e15, 3e12, 1e9), rel=1e-12)
    assert terms["compute_s"] == pytest.approx(1e15 / 989e12, rel=1e-12)
    # the host's constants when the chip follows a CPU device
    host = roofline.roofline_terms(1e15, 3e12, 1e9, device="cpu")
    assert host["memory_s"] == pytest.approx(3e12 / hardware.CPU_HOST.hbm_bandwidth)


def test_port_modules_import_no_jax_and_set_no_environment():
    code = (
        "import os, sys\n"
        "before = dict(os.environ)\n"
        "import repro_torch.configs.shapes, repro_torch.launch.roofline\n"
        "import repro_torch.launch.lint, repro_torch.models.config\n"
        "import repro_torch.core.stage_exec, repro_torch.core.resilience\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
        "assert dict(os.environ) == before, set(os.environ) ^ set(before)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr

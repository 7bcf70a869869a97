"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure exits nonzero; nothing runs on the CPU instead):

1. build   — build the split-pipeline kernel from the checkout's sources
             (``nvcc`` for sm_90a) and print the build seconds, the
             compiler's register report and the card's name and power limit;
2. kernel  — hold the kernel against its plain PyTorch version on the card:
             the lowered Black-Scholes, Haversine and quickstart programs at
             their main-path sizes, every opcode, and add/max/min reductions
             at n in {1, 1500, 1000003, 2**27} (mul at n <= 4096, values
             near 1);
3. main    — ``mozart.session(executor="cuda")`` on Black-Scholes and
             Haversine at n = 2**27 and on the quickstart chain: every stage
             on the kernel, the launch count moved, outputs equal to the
             ``eager`` executor on the card and to the float64 numpy oracle
             on a 2**20 prefix;
4. times   — CUDA-event medians of the kernel, its plain version, and host
             clock medians of the ``eager``, ``fused`` and ``cuda``
             executors on the same inputs, beside the kernel's bound.

The last two lines are a JSON ``kernels`` record and the device record.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_MAIN = 1 << 27
N_QUICKSTART = 1_000_000
PREFIX = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
REPLACES = "src/repro/kernels/split_pipeline.py:48"
SOURCE = "src/repro_torch/csrc/split_pipeline.cu"


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def compare(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol_scale: float = 2e-5, atol: float = 0.0) -> float:
    """Assert ``got`` matches ``want`` (NaN positions equal); returns the
    largest absolute difference over entries finite in both."""
    g, w = got.detach().double(), want.detach().double()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if got.dtype == torch.bool or want.dtype == torch.bool:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{what}: bool outputs differ")
        return 0.0
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{what}: NaN positions differ")
    fin = torch.isfinite(w) & torch.isfinite(g)
    if not torch.equal(torch.isinf(g), torch.isinf(w)) or \
            not torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]):
        raise AssertionError(f"{what}: infinities differ")
    if not bool(fin.any()):
        return 0.0
    gf, wf = g[fin], w[fin]
    tol = max(atol, atol_scale * float(wf.abs().max())) + rtol * wf.abs()
    diff = (gf - wf).abs()
    if bool((diff > tol).any()):
        i = int(torch.argmax(diff - tol))
        raise AssertionError(f"{what}: |{float(gf[i])} - {float(wf[i])}| "
                             f"exceeds rtol {rtol} / atol")
    return float(diff.max())


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of ``fn`` ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------


def phase_build(sp) -> float:
    path, secs, compiler_log = sp.build()
    log(f"[build] {path.name} built in {secs:.2f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    log(card_line())
    return secs


def lowered(fn, data):
    """The kernel launch (program, split inputs, broadcasts, out kinds) of
    the single stage ``fn`` plans to on ``data``."""
    from repro_torch.core import cuda_exec, mozart
    with mozart.session(executor="cuda") as ctx:
        outs = fn(**data)
        stages = ctx.last_plan()
        if len(stages) != 1:
            raise AssertionError(f"{fn.__name__}: {len(stages)} stages, expected 1")
        stage = stages[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        launch = cuda_exec.prepare_launch(stage, concrete, ctx)
        if launch is None:
            raise AssertionError(f"{fn.__name__}: stage does not lower to the kernel")
        del outs
    return launch


def phase_kernel(sp, ref, workloads_data) -> dict:
    from repro_torch.kernels import program as P
    errs = {}
    for name, (fn, data) in workloads_data.items():
        launch = lowered(fn, data)
        got = sp.split_pipeline(*launch)
        want = ref.split_pipeline_ref(*launch)
        torch.cuda.synchronize()
        err = 0.0
        for i, ((kind, _op), g, w) in enumerate(zip(launch[3], got, want)):
            rtol = 1e-4 if kind == "reduce" else 2e-5
            err = max(err, compare(f"{name} output {i}", g, w, rtol))
        errs[name] = (err, launch)
        log(f"[kernel] {name}: program of {len(launch[0].code)} ops, "
            f"{launch[0].n_slots} slots, n={launch[1][0].numel()}: "
            f"max |kernel - plain| = {err:.3e}")

    # every opcode, with split and broadcast operands, on a ragged length
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 100_003
    a = (torch.randn(n, generator=g) * 2.0)
    a[:6] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.0])
    b = torch.randn(n, generator=g) * 2.0 + 0.25
    c = (torch.rand(n, generator=g) > 0.5).to(torch.float32)
    ins = [t.cuda() for t in (a, b, c)]
    worst = 0.0
    for name, arity in P.OPCODES:
        for scalar in ((False, True) if arity >= 2 else (False,)):
            srcs = [P.operand(P.KIND_INPUT, i) for i in range(3)][:arity]
            bcast = []
            if scalar:
                srcs[1] = P.operand(P.KIND_SCALAR, 0)
                bcast = [0.75]
            prog = P.Program(
                code=((P.OP[name], 0, *srcs, *([0] * (3 - arity))),), n_split=3,
                n_bcast=len(bcast), n_slots=1, imms=(),
                outputs=((P.operand(P.KIND_SLOT, 0), name in P.BOOL_RESULT),))
            kinds = [("concat", "")]
            got = sp.split_pipeline(prog, ins, bcast, kinds)[0]
            want = ref.split_pipeline_ref(prog, ins, bcast, kinds)[0]
            worst = max(worst, compare(f"opcode {name} scalar={scalar}",
                                       got, want, 2e-5))
    # bool inputs load as 1.0/0.0
    bool_in = [x.cuda() for x in (a > 0, b > 0)]
    prog = P.Program(code=((P.OP["AND"], 0, P.operand(P.KIND_INPUT, 0),
                            P.operand(P.KIND_INPUT, 1), 0),),
                     n_split=2, n_bcast=0, n_slots=1, imms=(),
                     outputs=((P.operand(P.KIND_SLOT, 0), True),))
    compare("bool inputs", sp.split_pipeline(prog, bool_in, [], [("concat", "")])[0],
            (bool_in[0] & bool_in[1]), 0.0)
    log(f"[kernel] {len(P.OPCODES)} opcodes (split and broadcast operands): "
        f"max |kernel - plain| = {worst:.3e}")

    # reductions over ragged lengths
    red = P.Program(code=(), n_split=1, n_bcast=0, n_slots=0, imms=(),
                    outputs=((P.operand(P.KIND_INPUT, 0), False),))
    for op, sizes in (("add", (1, 1500, 1_000_003, N_MAIN)),
                      ("max", (1, 1500, 1_000_003, N_MAIN)),
                      ("min", (1, 1500, 1_000_003, N_MAIN)),
                      ("mul", (1, 1500, 4096))):
        for m in sizes:
            if op == "mul":
                x = 1.0 + 1e-3 * torch.randn(m, generator=g)
            else:
                x = torch.rand(m, generator=g) - 0.25
            x = x.cuda()
            got = sp.split_pipeline(red, [x], [], [("reduce", op)])[0]
            want = ref.split_pipeline_ref(red, [x], [], [("reduce", op)])[0]
            rtol = {"add": 1e-4, "mul": 1e-3}.get(op, 0.0)
            compare(f"reduce {op} n={m}", got, want, rtol, atol_scale=0.0)
            del x
    log("[kernel] reductions add/max/min at n in {1, 1500, 1000003, 2**27}, "
        "mul at n in {1, 1500, 4096}: agree")
    return errs


def phase_main(sp, workloads_data, oracles) -> dict:
    from repro_torch.core import mozart
    launches = {}
    for name, (fn, data) in workloads_data.items():
        sp.split_pipeline.launches = 0
        with mozart.session(executor="cuda") as ctx:
            outs = fn(**data)
            outs = outs if isinstance(outs, tuple) else (outs,)
            got = [o.value for o in outs]
        torch.cuda.synchronize()
        launched = sp.split_pipeline.launches
        stats = dict(ctx.stats)
        if not (stats.get("stages", 0) > 0
                and stats.get("cuda_stages", 0) == stats["stages"]
                and stats.get("cuda_fallback_stages", 0) == 0
                and launched == stats["cuda_stages"]):
            raise AssertionError(f"{name}: not every stage on the kernel: "
                                 f"{stats}, launches {launched}")
        launches[name] = launched
        with mozart.session(executor="eager") as ectx:
            eouts = fn(**data)
            eouts = eouts if isinstance(eouts, tuple) else (eouts,)
            want = [o.value for o in eouts]
        torch.cuda.synchronize()
        for i, (gv, wv) in enumerate(zip(got, want)):
            if gv.shape != wv.shape or gv.dtype != wv.dtype:
                raise AssertionError(f"{name} output {i}: {gv.shape}/{gv.dtype} "
                                     f"vs eager {wv.shape}/{wv.dtype}")
            if not bool(torch.isfinite(gv).all()):
                raise AssertionError(f"{name} output {i}: non-finite values")
            if name == "quickstart":
                compare(f"{name} vs eager", gv, wv, 1e-4)
            else:
                compare(f"{name} output {i} vs eager", gv, wv, 2e-5,
                        atol=1e-2 if name == "haversine" else 0.0)
        for i, (gv, (ref64, rtol, atol)) in enumerate(zip(got, oracles[name])):
            part = gv if gv.dim() == 0 else gv[:ref64.shape[0]]
            ok = np.allclose(part.double().cpu().numpy(), ref64, rtol=rtol, atol=atol)
            if not ok:
                raise AssertionError(f"{name} output {i}: float64 oracle mismatch")
        del got, want, outs, eouts
        log(f"[main] {name}: {stats} launches={launched}; "
            f"eager stats {dict(ectx.stats)}; matches eager and the float64 oracle")
    return launches


def phase_times(sp, ref, workloads_data, errs, launches) -> list:
    from repro_torch.core import mozart
    rows = []
    for name, (fn, data) in workloads_data.items():
        err, launch = errs[name]
        program, split_inputs, _bcasts, kinds = launch
        n = split_inputs[0].numel()
        in_bytes = sum(x.element_size() for x in split_inputs) * n
        out_bytes = sum(4 if kind == "reduce" else
                        (1 if is_bool else 4) * n
                        for (kind, _o), (_s, is_bool) in zip(kinds, program.outputs))
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = len(program.code) * n / F32_OPS_PER_S * 1e3
        kernel_ms = cuda_ms(lambda launch=launch: sp.split_pipeline(*launch), 20)
        plain_ms = cuda_ms(lambda launch=launch: ref.split_pipeline_ref(*launch), 5)

        def executor_run(ex, fn=fn, data=data):
            with mozart.session(executor=ex) as ctx:
                outs = fn(**data)
                outs = outs if isinstance(outs, tuple) else (outs,)
                vals = [o.value for o in outs]
            return vals, ctx

        e2e = {ex: host_ms(lambda ex=ex: executor_run(ex), 3)
               for ex in ("eager", "fused", "cuda")}
        _v, fctx = executor_run("fused")
        row = {
            "name": f"split_pipeline[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "n": n, "program_ops": len(program.code),
            "eager_ms": e2e["eager"], "fused_ms": e2e["fused"],
            "cuda_executor_ms": e2e["cuda"], "fused_chunks": fctx.stats["chunks"],
        }
        rows.append(row)
        log(f"[times] {name} n={n}: kernel {kernel_ms:.3f} ms (bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, "
            f"{row['bound_ms'] / kernel_ms:.1%} of it), plain {plain_ms:.3f} ms, "
            f"eager executor {e2e['eager']:.3f} ms, fused executor "
            f"{e2e['fused']:.3f} ms ({fctx.stats['chunks']} chunks), cuda "
            f"executor {e2e['cuda']:.3f} ms")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
            "this check runs on the card only")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from scipy.special import erf
    from repro_torch import workloads as w
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_pipeline as sp

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    phase_build(sp)

    t0 = time.perf_counter()
    bs = w.black_scholes_data(N_MAIN, seed=0, device="cuda")
    hv = w.haversine_data(N_MAIN, seed=0, device="cuda")
    qs = w.quickstart_data(N_QUICKSTART, device="cuda")
    torch.cuda.synchronize()
    log(f"[data] generated in {time.perf_counter() - t0:.1f} s")
    workloads_data = {"black_scholes": (w.black_scholes, bs),
                      "haversine": (w.haversine, hv),
                      "quickstart": (w.quickstart, qs)}
    bs_pre = {k: v[:PREFIX] for k, v in bs.items()}
    hv_pre = {k: v[:PREFIX] for k, v in hv.items()}
    call64, put64 = w.black_scholes_np(bs_pre, erf=erf)
    oracles = {
        "black_scholes": [(call64, 2e-3, 1e-3), (put64, 2e-3, 1e-3)],
        "haversine": [(w.haversine_np(**hv_pre), 2e-3, 1e-2)],
        "quickstart": [(np.float64(w.quickstart_np(**qs)), 1e-4, 0.0)],
    }

    errs = phase_kernel(sp, ref, workloads_data)
    launches = phase_main(sp, workloads_data, oracles)
    rows = phase_times(sp, ref, workloads_data, errs, launches)

    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} = {row[key]}")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

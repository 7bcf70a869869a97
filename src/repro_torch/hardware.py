"""Hardware constants for the Mozart batch heuristic and the cost figures.

The paper's batch-size heuristic sizes one pipeline batch to fit in fast
memory.  On the H100 the chunk-loop executors size their batches to L2 (the
split-pipeline kernel keeps its tile in one block's shared memory instead);
on the host CPU the fast tier is modelled as L3-scale.  A context's chip
follows from its device (``chip_for``), never from a hard-wired target.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_bf16_flops: float      # FLOP/s per chip
    hbm_bandwidth: float        # bytes/s per chip
    ici_link_bandwidth: float   # bytes/s per link to the other chips
    ici_links: int              # links per chip participating in a collective
    hbm_bytes: int              # device memory per chip
    vmem_bytes: int             # fast scratch memory one block/core may use
    # Fraction of fast memory one Mozart pipeline batch should occupy
    # (paper: "C x L2CacheSize", C fixed constant).
    mozart_c: float = 0.25
    # Per-dispatch overhead of launching ONE library call from the Python
    # driver loop (``measured_dispatch_overhead_s`` measures it per process).
    dispatch_overhead_s: float = 50e-6
    # One-time cost of building a new program for a stage.
    compile_overhead_s: float = 50e-3
    # Streaming multiprocessors (1 for a host CPU model).
    num_sms: int = 1
    # Size of the cache tier the chunk-loop batches are sized to; 0 means
    # "use vmem_bytes" (the CPU model keeps its fast tier there).
    l2_bytes: int = 0


# NVIDIA H100 SXM (data sheet and Hopper white paper): 989 TFLOP/s dense
# bf16, 80 GB HBM3 at 3.35 TB/s, 132 SMs, 50 MB L2, 227 KB of shared memory
# per block, NVLink 900 GB/s to the host's other cards (450 GB/s each way).
H100 = Chip(
    name="h100",
    peak_bf16_flops=989e12,
    hbm_bandwidth=3.35e12,
    ici_link_bandwidth=450e9,
    ici_links=2,
    hbm_bytes=80 * 10**9,
    vmem_bytes=232_448,
    dispatch_overhead_s=10e-6,
    num_sms=132,
    l2_bytes=50 * 10**6,
)

# The host the CPU tests run on.  The fast tier is modelled as L3-scale
# rather than L2: per-chunk dispatch goes through Python, which moves the
# useful chunk size up by orders of magnitude.
CPU_HOST = Chip(
    name="cpu_host",
    peak_bf16_flops=1e11,
    hbm_bandwidth=20e9,
    ici_link_bandwidth=10e9,
    ici_links=1,
    hbm_bytes=32 * 2**30,
    vmem_bytes=4 * 2**20,
    mozart_c=1.0,
)


def chip_for(device: torch.device | str) -> Chip:
    """The chip model of a device.  A CUDA device takes its L2 size, SM
    count, memory and opt-in shared memory per block from
    ``torch.cuda.get_device_properties``; the H100 data sheet supplies what
    the properties lack (bandwidths and peak flops).  Anything else is the
    host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_HOST
    props = torch.cuda.get_device_properties(
        dev.index if dev.index is not None else torch.cuda.current_device())
    return dataclasses.replace(
        H100,
        name=props.name,
        l2_bytes=int(props.L2_cache_size),
        num_sms=int(props.multi_processor_count),
        hbm_bytes=int(props.total_memory),
        vmem_bytes=int(props.shared_memory_per_block_optin),
    )


# ---------------------------------------------------------------------------
# Online dispatch-overhead calibration
# ---------------------------------------------------------------------------

_measured_dispatch_s: dict[str, float] = {}


def measured_dispatch_overhead_s(device: torch.device | str = "cuda") -> float:
    """Wall seconds of one warm torch no-op (``x + 1`` on a 0-d tensor),
    synchronised on the card for CUDA devices; measured once per device per
    process (median of 7 calls after one warm-up)."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _measured_dispatch_s:
        x = torch.zeros((), dtype=torch.float32, device=dev)

        def once():
            y = x + 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return y

        once()
        samples = []
        for _ in range(7):
            t0 = time.perf_counter()
            once()
            samples.append(time.perf_counter() - t0)
        _measured_dispatch_s[key] = max(sorted(samples)[len(samples) // 2], 1e-9)
    return _measured_dispatch_s[key]


def effective_dispatch_overhead_s(chip: Chip, device: torch.device | str) -> float:
    """Per-dispatch overhead the cost model charges: the chip constant
    blended (geometric mean) with the measured no-op dispatch on
    ``device``, so a constant that is wrong by 10x is corrected while a
    noisy measurement keeps the constant's scale."""
    return math.sqrt(chip.dispatch_overhead_s * measured_dispatch_overhead_s(device))


def fast_memory_bytes(chip: Chip) -> int:
    """Size of the 'cache' tier Mozart batches must fit in: L2 where the chip
    model has one, else its scratch tier."""
    return chip.l2_bytes or chip.vmem_bytes


def mozart_batch_elements(total_elem_bytes: int, chip: Chip) -> int:
    """Paper Section 5.2: batch = C * FastMem / sum(sizeof(element)).

    ``total_elem_bytes`` is the summed per-element byte width across every
    live split value in the stage (inputs + intermediates + outputs).
    """
    if total_elem_bytes <= 0:
        return 1
    n = int(chip.mozart_c * fast_memory_bytes(chip) / total_elem_bytes)
    return max(n, 1)

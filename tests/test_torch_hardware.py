"""``hardware.chip_for``: a CUDA device's chip takes its L2 size, SM count,
memory and opt-in shared memory per block from
``torch.cuda.get_device_properties`` (faked here: the CPU has no card), the
data sheet keeps bandwidth and flops, and the CPU path is unchanged."""

import types

import pytest
import torch

from repro_torch import hardware
from repro_torch.kernels import split_pipeline as sp

FAKE = types.SimpleNamespace(
    name="Fake GPU", L2_cache_size=60 * 2**20, multi_processor_count=114,
    total_memory=94 * 2**30, shared_memory_per_block_optin=101_376)


@pytest.fixture
def fake_card(monkeypatch):
    seen = []

    def props(index):
        seen.append(index)
        return FAKE

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    sp._sm_count.cache_clear()
    yield seen
    sp._sm_count.cache_clear()


def test_chip_takes_the_device_properties(fake_card):
    chip = hardware.chip_for(torch.device("cuda", 0))
    assert fake_card == [0]
    assert chip.l2_bytes == FAKE.L2_cache_size
    assert chip.num_sms == FAKE.multi_processor_count
    assert chip.hbm_bytes == FAKE.total_memory
    assert chip.vmem_bytes == FAKE.shared_memory_per_block_optin
    assert chip.name == FAKE.name
    # what the properties lack comes from the data sheet
    assert chip.hbm_bandwidth == hardware.H100.hbm_bandwidth
    assert chip.peak_bf16_flops == hardware.H100.peak_bf16_flops
    assert hardware.fast_memory_bytes(chip) == FAKE.L2_cache_size
    assert hardware.mozart_batch_elements(12, chip) == int(0.25 * FAKE.L2_cache_size / 12)


def test_kernel_sm_count_agrees_with_the_chip(fake_card):
    assert sp._sm_count(1) == hardware.chip_for(torch.device("cuda", 1)).num_sms == 114


def test_cpu_path_unchanged():
    assert hardware.chip_for("cpu") is hardware.CPU_HOST
    assert hardware.chip_for(torch.device("cpu")) is hardware.CPU_HOST
    from repro_torch.core import mozart
    with mozart.session(device="cpu") as ctx:
        assert ctx.chip is hardware.CPU_HOST

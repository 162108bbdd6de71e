"""Device capability table — the hardware half of "hardware-aware" (twin
of ``repro.tune.device``).

A ``DeviceSpec`` holds what the cost model and plan validator need about
one device kind.  ``gpu-h100`` is the device the port's CUDA kernels are
built for (``sm_90a``): every card of compute capability 9.0 gets it,
whatever its name; other cards run the plain PyTorch paths.  Numbers
are published peaks (NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 989
TFLOP/s dense bf16, 67 TFLOP/s fp32 outside the tensor cores); they feed
a relative roofline, not a measurement.

``REPRO_TORCH_TUNE_DEVICE=<table key>`` (or ``repro_torch.configure(
device=...)``, which takes precedence) forces a spec (so a CPU host can
resolve plans for the card, and tests can drive the card's dispatch
decisions on CPU tensors — the kernel wrappers then run their plain
versions).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import config

#: environment variable that forces a DeviceSpec by table key
DEVICE_ENV = "REPRO_TORCH_TUNE_DEVICE"


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Capabilities of one device kind, as seen by the tuner."""

    kind: str                  # table key, also the plan-cache key part
    smem_bytes: int            # shared memory one block can use
    hbm_gbps: float            # device-memory bandwidth, GB/s
    low_tflops: float          # peak bf16 matmul TFLOP/s
    fp32_tflops: float         # peak fp32 FMA TFLOP/s (non-tensor-core)
    launch_overhead_s: float   # fixed cost per kernel launch
    kernels: bool              # the port's CUDA kernels run here


DEVICE_TABLE: dict[str, DeviceSpec] = {
    "gpu-h100": DeviceSpec(
        kind="gpu-h100", smem_bytes=227 * 2**10, hbm_gbps=3350.0,
        low_tflops=989.0, fp32_tflops=67.0, launch_overhead_s=4e-6,
        kernels=True),
    # a CUDA card the kernels are not built for: plain PyTorch paths
    "gpu-a100": DeviceSpec(
        kind="gpu-a100", smem_bytes=163 * 2**10, hbm_gbps=2039.0,
        low_tflops=312.0, fp32_tflops=19.5, launch_overhead_s=4e-6,
        kernels=False),
    "cpu": DeviceSpec(
        kind="cpu", smem_bytes=0, hbm_gbps=30.0, low_tflops=0.2,
        fp32_tflops=0.2, launch_overhead_s=2e-5, kernels=False),
}

#: compute capability the kernels are built for (``sm_90a``)
KERNEL_CAPABILITY = (9, 0)


def detect_device(device: torch.device | str | None = None) -> DeviceSpec:
    """The DeviceSpec of ``device`` (default: cuda if available, else
    cpu), unless the ``device`` setting (``REPRO_TORCH_TUNE_DEVICE``)
    forces one."""
    forced = config.get("device")
    if forced:
        if forced not in DEVICE_TABLE:
            raise KeyError(f"{DEVICE_ENV}={forced!r} not in device table "
                           f"{sorted(DEVICE_TABLE)}")
        return DEVICE_TABLE[forced]
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return DEVICE_TABLE["cpu"]
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return DEVICE_TABLE[_cuda_kind(index)]


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    """Table key of CUDA device ``index``: ``gpu-h100`` for a Hopper card
    (compute capability 9.0, what ``sm_90a`` runs on — H100, H200, GH200
    alike), the plain-path spec for any other card."""
    if tuple(torch.cuda.get_device_capability(index)) == KERNEL_CAPABILITY:
        return "gpu-h100"
    return "gpu-a100"

"""Published figures of the accelerators this program runs on.

One table, keyed by JAX's ``device_kind``, for every place that needs a
device rate: the benchmarks' roofline shares and the interconnect model
that picks the sharded SGM mode (parallel/ici_model.py).  A device that is
not in the table is an error, never a default: a rate borrowed from
another part would make every share derived from it wrong.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at the full
700 W power limit (a card capped below it
cannot hold its top clock under load; benchmarks print ``power.limit``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class DeviceSpec:
    hbm_bytes_per_s: float      # device memory bandwidth
    link_bytes_per_s: float     # NVLink to the other cards, each way
    source: str


H100_SXM = DeviceSpec(
    hbm_bytes_per_s=3.35e12,
    link_bytes_per_s=450e9,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM5)",
)

SPECS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


class UnknownDeviceError(LookupError):
    """No published figures for this ``device_kind``."""


def device_spec(device_kind: str | None = None) -> DeviceSpec:
    """Figures for ``device_kind`` (default: JAX's first device)."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return SPECS[device_kind]
    except KeyError:
        raise UnknownDeviceError(
            f"no published figures for device kind {device_kind!r}; add "
            "them to stereomatch_tpu/utils/devices.py::SPECS with their "
            "source") from None

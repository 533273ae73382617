"""The card's energy, from NVIDIA's management library (NVML).

NVML is ``libnvidia-ml.so.1``, which the NVIDIA driver installs beside
``nvidia-smi``; it is called through ``ctypes``.  The card is found by the
UUID of the CUDA device (or, failing that, by its PCI bus id), never by
NVML's index 0, which need not be the device the run uses.

Two sources, in this order:

* ``nvml_total_energy``: the card's own energy counter
  (``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
  loaded);
* ``nvml_power_sampled``: where the counter is not supported, the power
  draw (``nvmlDeviceGetPowerUsage``, milliwatts) sampled at 50 Hz by a
  thread and integrated by the trapezoid rule.

A run that can read neither fails: no energy is estimated from time.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

_OK = 0
_SAMPLE_HZ = 50.0


class EnergyUnavailable(RuntimeError):
    pass


class NvmlEnergy:
    def __init__(self, device_index: int = 0):
        import torch
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise EnergyUnavailable(f"libnvidia-ml.so.1: {e}") from e
        self._lib = lib
        dev = ctypes.c_void_p
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByUUID",
                 [ctypes.c_char_p, ctypes.POINTER(dev)]),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(dev)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [dev, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetPowerUsage",
                 [dev, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [dev, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetName",
                 [dev, ctypes.c_char_p, ctypes.c_uint])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        self._call("nvmlInit_v2")
        self._handle = self._find(torch.cuda.get_device_properties(
            device_index))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mj0 = self._counter_mj()
        if self._mj0 is not None:
            self.source = "nvml_total_energy"
            return
        if self._power_mw() is None:
            raise EnergyUnavailable(
                "NVML reads neither the card's energy counter nor its power")
        self.source = "nvml_power_sampled"
        self._joules = 0.0
        self._last = (time.perf_counter(), self._power_mw())
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _call(self, name, *args) -> None:
        err = getattr(self._lib, name)(*args)
        if err != _OK:
            raise EnergyUnavailable(f"{name} returned NVML error {err}")

    def _find(self, props):
        handle = ctypes.c_void_p()
        uuid = str(getattr(props, "uuid", "") or "")
        if uuid:
            uuid = uuid if uuid.startswith(("GPU-", "MIG-")) else "GPU-" + uuid
            if self._lib.nvmlDeviceGetHandleByUUID(
                    uuid.encode(), ctypes.byref(handle)) == _OK:
                return handle
        bus = getattr(props, "pci_bus_id", None)
        if bus is not None:
            bus_id = "%08X:%02X:%02X.0" % (getattr(props, "pci_domain_id", 0),
                                           bus, getattr(props,
                                                        "pci_device_id", 0))
            if self._lib.nvmlDeviceGetHandleByPciBusId_v2(
                    bus_id.encode(), ctypes.byref(handle)) == _OK:
                return handle
        raise EnergyUnavailable(
            f"no NVML device with the CUDA device's UUID {uuid!r} or PCI "
            f"bus id")

    def _counter_mj(self) -> Optional[int]:
        v = ctypes.c_ulonglong()
        err = self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(v))
        return int(v.value) if err == _OK else None

    def _power_mw(self) -> Optional[int]:
        v = ctypes.c_uint()
        err = self._lib.nvmlDeviceGetPowerUsage(self._handle, ctypes.byref(v))
        return int(v.value) if err == _OK else None

    def _sample(self) -> None:
        while not self._stop.wait(1.0 / _SAMPLE_HZ):
            self._tick()

    def _tick(self) -> None:
        mw = self._power_mw()
        if mw is None:
            return
        now = time.perf_counter()
        with self._lock:
            t, p = self._last
            self._joules += (now - t) * (p + mw) / 2e3
            self._last = (now, mw)

    def joules(self) -> float:
        """Energy since this reader started."""
        if self.source == "nvml_total_energy":
            mj = self._counter_mj()
            if mj is None:
                raise EnergyUnavailable("the energy counter stopped reading")
            return (mj - self._mj0) / 1e3
        self._tick()
        with self._lock:
            return self._joules

    def power_limit_w(self) -> Optional[float]:
        v = ctypes.c_uint()
        err = self._lib.nvmlDeviceGetEnforcedPowerLimit(self._handle,
                                                        ctypes.byref(v))
        return v.value / 1e3 if err == _OK else None

    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        if self._lib.nvmlDeviceGetName(self._handle, buf, 96) != _OK:
            return "?"
        return buf.value.decode(errors="replace")

    def close(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._lib.nvmlShutdown()

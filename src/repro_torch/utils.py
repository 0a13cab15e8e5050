"""Shared small utilities: device resolution, host<->device copies, the
disk cache, memoized device predict fns, and the float32 precision
policy."""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable

import numpy as np
import torch

CACHE_DIR = os.environ.get(
    "REPRO_CACHE",
    os.path.join(os.path.dirname(__file__), "..", "..", ".cache"))


def cache_path(*key: Any, ext: str = "npz") -> str:
    """Disk-cache file for `key`. Callers lead the key with a
    port-specific prefix ("gt-torch-v1", ...) so the port never reads an
    artifact the JAX package wrote into the same directory."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    blob = json.dumps([repr(k) for k in key], sort_keys=True).encode()
    h = hashlib.sha1(blob).hexdigest()[:16]
    return os.path.join(CACHE_DIR, f"{h}.{ext}")


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The torch.device an entry point runs on. A CUDA request without a
    GPU raises: the port never falls back to the CPU on its own — the
    caller asks for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(device)!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda":
        set_fp32_precision()
    return dev


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device` (a copy). On the card the copy goes
    through pinned memory and does not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def start_host_copy(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start the device->host copy of `t`; the returned callable waits for
    it and yields the numpy array."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy()
    return wait


def set_fp32_precision() -> None:
    """Run every float32 product in full float32. TF32 keeps ~10 mantissa
    bits, which would flip neighbour counts near eps and move the
    estimator's predictions across the XDT threshold; the reference
    computes every dot in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def memoize_device_fn(obj, key, build):
    """Per-object memo for device predict fns (estimator protocol): the
    SAME fn object comes back across calls until `key` changes."""
    if getattr(obj, "_device_fn", None) is None or obj._device_fn_key != key:
        obj._device_fn, obj._device_fn_key = build(), key
    return obj._device_fn

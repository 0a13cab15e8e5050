"""Fused MLP-regressor inference: the Xling estimator's forward, which
the filter runs on every query batch and XDT calibrates with.

`mlp_forward` is the wrapper. On a CUDA tensor it launches the
hand-written kernel `csrc/fused_mlp.cu` (which replaces the TPU kernel
`repro/kernels/fused_mlp.py::mlp_forward_pallas`; the source says what
bounds it and how it is laid out) and bumps `KERNEL.launches`. On a CPU
tensor it runs `mlp_forward_plain`, the PyTorch version of the same
function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_mlp", {
    "mlp_forward": (ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _P]),
})

MAX_LAYERS = 8
#: dynamic shared memory one CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232448


def plan_tile(dims) -> tuple[int, int, int]:
    """(rows per CTA, feature rows of activation buffer 0, of buffer 1).

    Layer l reads buffer l % 2 and writes buffer (l + 1) % 2; the last
    layer writes straight to the output. 32 rows per CTA when both
    buffers fit the shared-memory limit at a padded stride of 36 rows,
    else 16; wider inputs raise."""
    widths = list(dims[:-1])
    size0 = max(widths[0::2])
    size1 = max(widths[1::2], default=0)
    for bn in (32, 16):
        if (size0 + size1) * (bn + 4) * 4 <= SMEM_LIMIT:
            return bn, size0, size1
    raise ValueError(f"mlp_forward: activations of widths {widths} do not "
                     f"fit {SMEM_LIMIT} B of shared memory at 16 rows per CTA")


def _check(params, x):
    if x.ndim != 2 or x.dtype != torch.float32:
        raise TypeError(f"mlp_forward: x must be float32 [n, d0], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not 1 <= len(params) <= MAX_LAYERS:
        raise ValueError(f"mlp_forward: {len(params)} layers, expected 1.."
                         f"{MAX_LAYERS}")
    dims = [x.shape[1]]
    for li, (w, b) in enumerate(params):
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"mlp_forward: layer {li} must be float32")
        if w.device != x.device or b.device != x.device:
            raise ValueError(f"mlp_forward: layer {li} is on {w.device}, "
                             f"x on {x.device}")
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.numel() != w.shape[1]:
            raise ValueError(f"mlp_forward: layer {li} has w "
                             f"{tuple(w.shape)}, b {tuple(b.shape)} after "
                             f"width {dims[-1]}")
        dims.append(w.shape[1])
    if dims[-1] != 1:
        raise ValueError(f"mlp_forward: last layer has dout={dims[-1]}, "
                         "expected 1")
    return dims


def mlp_forward_plain(params, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: h = relu(h @ w + b) per layer, no ReLU
    after the last. Returns f32 [n]."""
    _check(params, x)
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b.reshape(1, -1)
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[:, 0]


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP forward, f32 [n]. params: sequence of (w [din, dout],
    b [1, dout] or [dout]) in the JAX layout, final dout 1. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return mlp_forward_plain(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_forward: unsupported device {x.device}")
    dims = _check(params, x)
    bn, size0, size1 = plan_tile(dims)
    x = x.contiguous()
    ws = [w.contiguous() for w, _ in params]
    bs = [b.contiguous() for _, b in params]
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    n_layers = len(params)
    code = KERNEL.lib().mlp_forward(
        x.data_ptr(), out.data_ptr(),
        (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws]),
        (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in bs]),
        (ctypes.c_int * (n_layers + 1))(*dims), n_layers, x.shape[0], bn,
        size0, size1, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    KERNEL.check(code)
    KERNEL.launches += 1
    return out

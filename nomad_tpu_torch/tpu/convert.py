"""Carry the encoded scan state across to torch.

``encode_eval`` (here and in ``nomad_tpu``) and ``example_scan_inputs``
build an eval's scan inputs as numpy ``static``, ``carry`` and ``xs``
tuples. These helpers turn such tuples into torch tensors on a device,
keeping every dtype (0-d numpy scalars become 0-d tensors, bool planes
stay ``torch.bool``), and bring outputs back. The tests feed the JAX
scan and the port the same numpy arrays through them.

``pack`` / ``unpack`` lay a tuple of arrays out in one byte buffer (each
at a 16-byte aligned offset) and view it back as tensors of the same
dtypes and shapes: ``to_device_packed`` moves a whole encode to the card
with ONE copy from pinned host memory, and ``from_device_packed`` brings
a packed buffer of outputs back with one copy.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU.
    Asking for CUDA where there is none raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_torch(arrays: Iterable, device: DeviceLike = "cuda") -> Tuple[torch.Tensor, ...]:
    """Copy each numpy array (or numpy scalar) to a tensor on ``device``
    with the same dtype. The copy never aliases the numpy buffer, so
    in-place kernel updates leave cached encodes untouched."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.array(a, copy=True)).to(dev) for a in arrays
    )


def scan_inputs_to_torch(static, carry, xs, device: DeviceLike = "cuda"):
    """(static, carry, xs) numpy tuples -> the same tuples as tensors."""
    return (to_torch(static, device), to_torch(carry, device),
            to_torch(xs, device))


def to_numpy(tensors: Iterable[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Tensors (any device) -> numpy arrays of the same dtypes."""
    return tuple(t.detach().cpu().numpy() for t in tensors)


#: (byte offset, numpy dtype, shape) of each array in a packed buffer
Layout = List[Tuple[int, np.dtype, Tuple[int, ...]]]

_TORCH_OF = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
             np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
             np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
             np.dtype(np.bool_): torch.bool, np.dtype(np.int16): torch.int16}


def pack(arrays: Sequence, pin: bool = False) -> Tuple[torch.Tensor, Layout]:
    """Copy each numpy array (or scalar) into one uint8 host tensor, each
    at a 16-byte aligned offset, with one ``np.concatenate``; pinned when
    ``pin`` (needs CUDA). Returns the buffer and its layout."""
    arrs = [np.asarray(a) for a in arrays]
    layout: Layout = []
    parts = []
    off = 0
    for a in arrs:
        pad = -off % 16
        if pad:
            parts.append(np.zeros(pad, np.uint8))
        off += pad
        layout.append((off, a.dtype, tuple(a.shape)))
        parts.append(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        off += a.nbytes
    buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin)
    if off:
        np.concatenate(parts, out=buf.numpy()[:off])
    return buf, layout


def unpack(buf: torch.Tensor, layout: Layout) -> Tuple[torch.Tensor, ...]:
    """The arrays of ``layout`` as tensor views into ``buf`` (any
    device). Each view costs three tensor operations, each of which lets
    go of the GIL: the hot path reads the buffer through its layout
    instead (``kernels.chunk_scan_packed``)."""
    out = []
    for o, dt, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[o:o + n].view(_TORCH_OF[dt]).view(shape))
    return tuple(out)


def to_device_packed(arrays: Sequence, device: DeviceLike = "cuda") -> Tuple[torch.Tensor, Layout]:
    """The arrays packed into one buffer on ``device`` and its layout: on
    CUDA, one ``non_blocking`` copy from pinned host memory on the
    current stream (the buffer is valid in that stream's order); on the
    CPU the packed host buffer itself. Like ``to_torch``, nothing
    aliases the numpy arrays."""
    dev = resolve_device(device)
    buf, layout = pack(arrays, pin=dev.type == "cuda")
    if dev.type == "cuda":
        buf = buf.to(dev, non_blocking=True)
    return buf, layout


def from_device_packed(buf: torch.Tensor, layout: Layout) -> Tuple[np.ndarray, ...]:
    """The arrays of ``layout`` in ``buf`` back as numpy arrays with one
    copy: on CUDA into pinned host memory on the current stream, which
    is then synchronized."""
    end = max((o + int(np.prod(shape, dtype=np.int64)) * dt.itemsize
               for o, dt, shape in layout), default=0)
    if buf.device.type == "cuda":
        host = torch.empty(max(end, 1), dtype=torch.uint8, pin_memory=True)
        host[:end].copy_(buf[:end], non_blocking=True)
        torch.cuda.current_stream(buf.device).synchronize()
    else:
        host = buf
    raw = host.numpy()
    return tuple(raw[o:o + int(np.prod(shape, dtype=np.int64)) * dt.itemsize]
                 .view(dt).reshape(shape).copy() for o, dt, shape in layout)

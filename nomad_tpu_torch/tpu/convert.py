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
a packed buffer of outputs back with one copy. ``HostSlab`` is a reused
host buffer that a caller packs a batch into itself (the batcher's
``pack_batch``) and moves with one copy.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

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


def put_bytes(dst: memoryview, off: int, a) -> None:
    """Copy the bytes of the numpy array ``a`` (C order) into ``dst`` at
    ``off``, holding the GIL: numpy lets go of it for a copy of more than
    500 elements, and where other threads are busy each such copy then
    waits up to a switch interval (5 ms) to take it back; a memoryview
    copy is one memcpy that keeps it."""
    a = np.ascontiguousarray(a)
    if a.nbytes:
        dst[off:off + a.nbytes] = memoryview(a).cast("B")


def pack(arrays: Sequence, pin: bool = False) -> Tuple[torch.Tensor, Layout]:
    """Copy each numpy array (or scalar) into one uint8 host tensor, each
    at a 16-byte aligned offset (``put_bytes``: the GIL is held
    throughout); pinned when ``pin`` (needs CUDA). Returns the buffer and
    its layout."""
    arrs = [np.asarray(a) for a in arrays]
    layout: Layout = []
    off = 0
    for a in arrs:
        off += -off % 16
        layout.append((off, a.dtype, tuple(a.shape)))
        off += a.nbytes
    buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin)
    raw = memoryview(buf.numpy())
    for (o, _dt, _shape), a in zip(layout, arrs):
        put_bytes(raw, o, a)
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
    is then synchronized. Each array is then copied out of it holding
    the GIL (a ``bytearray`` of its bytes; see ``put_bytes``)."""
    end = max((o + int(np.prod(shape, dtype=np.int64)) * dt.itemsize
               for o, dt, shape in layout), default=0)
    if buf.device.type == "cuda":
        host = torch.empty(max(end, 1), dtype=torch.uint8, pin_memory=True)
        host[:end].copy_(buf[:end], non_blocking=True)
        torch.cuda.current_stream(buf.device).synchronize()
    else:
        host = buf
    raw = memoryview(host.numpy())
    out = []
    for o, dt, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(np.frombuffer(bytearray(raw[o:o + n]), dt).reshape(shape))
    return tuple(out)


class HostSlab:
    """A reused host buffer to pack into, pinned when it feeds a CUDA
    device. ``take(nbytes)`` returns it as a numpy uint8 array of at
    least ``nbytes`` once the last copy out of it has finished (an event
    recorded behind that copy), growing it to the next power of two
    where it is short; ``to_device(nbytes, device)`` moves its first
    ``nbytes`` with ONE ``non_blocking`` copy on the current stream and
    records that event (on the CPU, one copy too: what it returns never
    aliases the slab). One thread uses a slab at a time."""

    def __init__(self, pin: bool) -> None:
        self.pin = pin
        self._buf: Optional[torch.Tensor] = None
        self._event = None

    def take(self, nbytes: int) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = torch.empty(1 << max(nbytes - 1, 0).bit_length(), dtype=torch.uint8,
                                    pin_memory=self.pin)
        return self._buf.numpy()

    def to_device(self, nbytes: int, device: torch.device) -> torch.Tensor:
        host = self._buf[:max(nbytes, 1)]
        if device.type != "cuda":
            return host.clone()
        out = host.to(device, non_blocking=True)
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(device))
        return out

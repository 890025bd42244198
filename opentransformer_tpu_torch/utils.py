"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. ``None`` means CUDA and raises when no card is present —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits and moves the conv frontend away from the JAX reference;
    the matmul flag is set too so both are stated in one place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class GrowingBuffer:
    """Append-only tensor buffer along one axis with capacity doubling
    (amortized O(1) an append): the streamed recognizers accumulate encoder
    memory chunk by chunk where it was computed, on the card, and the
    search reads ``view()`` there, so no chunk makes a round trip through
    the host and no append re-copies the history."""

    def __init__(self, axis: int = 0):
        self.axis = axis
        self.buf: torch.Tensor | None = None
        self.n = 0

    def append(self, x: torch.Tensor) -> None:
        t = x.shape[self.axis]
        if self.buf is None:
            shape = list(x.shape)
            shape[self.axis] = max(64, t)
            self.buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        cap = self.buf.shape[self.axis]
        if self.n + t > cap:
            shape = list(self.buf.shape)
            shape[self.axis] = max(self.n + t, 2 * cap)
            grown = torch.empty(shape, dtype=self.buf.dtype, device=self.buf.device)
            grown.narrow(self.axis, 0, self.n).copy_(self.view())
            self.buf = grown
        self.buf.narrow(self.axis, self.n, t).copy_(x)
        self.n += t

    def view(self) -> torch.Tensor | None:
        """The appended data [.., n, ..] without a copy (None if empty)."""
        if self.buf is None:
            return None
        return self.buf.narrow(self.axis, 0, self.n)

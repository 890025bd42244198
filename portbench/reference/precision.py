"""The precision of the reference's products.

``FP32`` is the reference itself: float32 products with TF32 switched off.
The controls put the reference in the port's place one precision below the
configuration's: ``FP8`` rounds both operands of every product of a linear
layer or convolution to float8 e4m3 with one scale a tensor (the step below
bfloat16), and ``TF32`` lets those products run in TF32 (the step below
float32 with TF32 off). Attention's products stay in float32 in all three.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor, back in float32;
    the gradient passes through the rounding unchanged."""
    with torch.no_grad():
        s = x.abs().amax().clamp_min(1e-12) / E4M3_MAX
        q = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Precision:
    def __init__(self, name: str, rnd=None, tf32: bool = False):
        self.name, self.rnd, self.tf32 = name, rnd, tf32

    def _set(self):
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w.T"""
        self._set()
        if self.rnd is not None:
            x, w = self.rnd(x), self.rnd(w)
        return x @ w.T

    def conv2d(self, x, w, b, **kw):
        self._set()
        if self.rnd is not None:
            x, w = self.rnd(x), self.rnd(w)
        return F.conv2d(x, w, b, **kw)

    def conv1d(self, x, w, b=None, **kw):
        self._set()
        if self.rnd is not None:
            x, w = self.rnd(x), self.rnd(w)
        return F.conv1d(x, w, b, **kw)


FP32 = Precision("float32")
FP8 = Precision("float8_e4m3", rnd=fp8)
TF32 = Precision("tf32", tf32=True)
BELOW = {"bfloat16": FP8, "float32": TF32}

"""Conv frontend (counterpart of ``opentransformer_tpu/models/frontend.py``).

Two Conv2d subsampling layers with the reference's geometry — time padding
0, frequency padding k//2, mask rule ``mask[:, k//2::stride][:, :T']`` —
then a channel-major flatten to [B, T', C·F'] and a projection. The JAX
package convolves NHWC (H = time, W = frequency); PyTorch convolves NCHW
over the same axes, and ``compat`` turns the HWIO kernels into OIHW.

Float32 convolutions run in TF32 under cuDNN by default; the port's entry
points switch that off for float32 models (``utils.disable_tf32``).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..ops.masks import subsample_mask
from .modules import ACTIVATIONS


def conv_out_len(t: int, kernel: int, stride: int, padding: int = 0) -> int:
    return (t + 2 * padding - kernel) // stride + 1


class Conv2dSubsampleLayer(nn.Module):
    def __init__(self, in_channel: int, out_channel: int, kernel_size=(3, 3),
                 stride: int = 2, act_func_type: str = "relu"):
        super().__init__()
        self.kt, self.kf = int(kernel_size[0]), int(kernel_size[1])
        self.stride = int(stride)
        self.act = ACTIVATIONS[act_func_type]
        self.conv = nn.Conv2d(in_channel, out_channel, (self.kt, self.kf),
                              stride=(self.stride, self.stride), padding=(0, self.kf // 2))

    def out_features(self, f: int) -> int:
        return conv_out_len(f, self.kf, self.stride, self.kf // 2)

    def forward(self, x, mask):
        # x: [B, C, T, F]; mask: bool[B, T]
        h = self.act(self.conv(x))
        return h, subsample_mask(mask, self.kt, self.stride)[:, : h.shape[2]]


class ConvFrontEnd(nn.Module):
    def __init__(self, input_size: int, output_size: int, in_channel: int = 1,
                 mid_channel: int = 32, out_channel: int = 128,
                 kernel_size: Sequence[Sequence[int]] = ((3, 3), (3, 3)),
                 stride: Sequence[int] = (2, 2), act_func_type: str = "relu"):
        super().__init__()
        if in_channel != 1:
            raise ValueError("ConvFrontEnd takes [B, T, F] features (in_channel 1)")
        self.conv1 = Conv2dSubsampleLayer(1, mid_channel, kernel_size[0], stride[0], act_func_type)
        self.conv2 = Conv2dSubsampleLayer(mid_channel, out_channel, kernel_size[1], stride[1],
                                          act_func_type)
        f_out = self.conv2.out_features(self.conv1.out_features(input_size))
        self.output_layer = nn.Linear(out_channel * f_out, output_size)

    def forward(self, x, mask):
        """x: [B, T, F]; mask: bool[B, T] → ([B, T', D], bool[B, T'])."""
        h, mask = self.conv1(x[:, None], mask)
        h, mask = self.conv2(h, mask)
        b, c, t, f = h.shape
        return self.output_layer(h.permute(0, 2, 1, 3).reshape(b, t, c * f)), mask

"""Frontends (counterpart of ``opentransformer_tpu/models/frontend.py``).

``ConvFrontEnd``: two Conv2d subsampling layers with the reference's
geometry — time padding 0, frequency padding k//2, mask rule
``mask[:, k//2::stride][:, :T']``, dropout after each activation in
training — then a channel-major flatten to [B, T', C·F'], a projection and, with
``front_end_layer_norm``, a LayerNorm (``layer_norm``). The JAX package
convolves NHWC (H = time, W = frequency); PyTorch convolves NCHW over the
same axes, and ``compat`` turns the HWIO kernels into OIHW.

Float32 convolutions run in TF32 under cuDNN by default; the port's entry
points switch that off for float32 models (``utils.disable_tf32``).

``ConcatFrontEnd``: frame stacking, then an optional projection.

``WhisperFrontEnd``: Whisper's two Conv1d over time (the mel bins as
channels), kernel 3, padding 1, the second of stride 2, each followed by
the exact GELU: T frames become ceil(T / 2), mask ``mask[:, ::2]``.

Each frontend's ``output_length(t)`` gives the frames it makes of ``t``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..ops.masks import subsample_mask
from .modules import ACTIVATIONS, Dropout, layer_norm


def conv_out_len(t: int, kernel: int, stride: int, padding: int = 0) -> int:
    return (t + 2 * padding - kernel) // stride + 1


class Conv2dSubsampleLayer(nn.Module):
    def __init__(self, in_channel: int, out_channel: int, kernel_size=(3, 3),
                 stride: int = 2, act_func_type: str = "relu", dropout: float = 0.0):
        super().__init__()
        self.kt, self.kf = int(kernel_size[0]), int(kernel_size[1])
        self.stride = int(stride)
        self.act = ACTIVATIONS[act_func_type]
        self.conv = nn.Conv2d(in_channel, out_channel, (self.kt, self.kf),
                              stride=(self.stride, self.stride), padding=(0, self.kf // 2))
        self.dropout = Dropout(dropout)

    def out_features(self, f: int) -> int:
        return conv_out_len(f, self.kf, self.stride, self.kf // 2)

    def forward(self, x, mask):
        # x: [B, C, T, F]; mask: bool[B, T]
        h = self.dropout(self.act(self.conv(x)))
        return h, subsample_mask(mask, self.kt, self.stride)[:, : h.shape[2]]


class ConvFrontEnd(nn.Module):
    def __init__(self, input_size: int, output_size: int, in_channel: int = 1,
                 mid_channel: int = 32, out_channel: int = 128,
                 kernel_size: Sequence[Sequence[int]] = ((3, 3), (3, 3)),
                 stride: Sequence[int] = (2, 2), act_func_type: str = "relu",
                 dropout: float = 0.0, front_end_layer_norm: bool = False):
        super().__init__()
        if in_channel != 1:
            raise ValueError("ConvFrontEnd takes [B, T, F] features (in_channel 1)")
        self.input_size = input_size
        self.conv1 = Conv2dSubsampleLayer(1, mid_channel, kernel_size[0], stride[0], act_func_type,
                                          dropout)
        self.conv2 = Conv2dSubsampleLayer(mid_channel, out_channel, kernel_size[1], stride[1],
                                          act_func_type, dropout)
        f_out = self.conv2.out_features(self.conv1.out_features(input_size))
        self.output_layer = nn.Linear(out_channel * f_out, output_size)
        self.layer_norm = layer_norm(output_size) if front_end_layer_norm else None

    def output_length(self, t: int) -> int:
        """Output frames for ``t`` input frames (no time padding)."""
        for layer in (self.conv1, self.conv2):
            t = conv_out_len(t, layer.kt, layer.stride)
        return t

    def forward(self, x, mask):
        """x: [B, T, F]; mask: bool[B, T] → ([B, T', D], bool[B, T'])."""
        h, mask = self.conv1(x[:, None], mask)
        h, mask = self.conv2(h, mask)
        b, c, t, f = h.shape
        h = self.output_layer(h.permute(0, 2, 1, 3).reshape(b, t, c * f))
        if self.layer_norm is not None:
            h = self.layer_norm(h)
        return h, mask


class ConcatFrontEnd(nn.Module):
    """Stack ``left_frames + 1 + right_frames`` frames every
    ``frame_rate // 10`` frames, as torch's Unfold (only full windows:
    ``T' = (T − ctx)//stride + 1``); mask ``mask[:, left::stride][:, :T']``;
    then, with ``with_linear``, a projection and dropout."""

    def __init__(self, input_size: int, output_size: int, left_frames: int = 3,
                 right_frames: int = 0, frame_rate: int = 30, with_linear: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.left_frames = left_frames
        self.ctx = left_frames + right_frames + 1
        self.stride = max(frame_rate // 10, 1)
        self.output_layer = nn.Linear(self.ctx * input_size, output_size) if with_linear else None
        self.dropout = Dropout(dropout)

    def output_length(self, t: int) -> int:
        return max(0, (t - self.ctx) // self.stride + 1)

    def forward(self, x, mask):
        """x: [B, T, F]; mask: bool[B, T] → ([B, T', D], bool[B, T'])."""
        b, _, f = x.shape
        h = x.unfold(1, self.ctx, self.stride)  # [B, T', F, ctx]
        t_out = h.shape[1]
        h = h.transpose(2, 3).reshape(b, t_out, self.ctx * f)
        mask = mask[:, self.left_frames :: self.stride][:, :t_out]
        if self.output_layer is not None:
            h = self.dropout(self.output_layer(h))
        return h, mask


class WhisperFrontEnd(nn.Module):
    """Conv1d(F → D, k 3, pad 1) → GELU → Conv1d(D → D, k 3, stride 2,
    pad 1) → GELU over [B, T, F] features (Radford et al., 2022)."""

    def __init__(self, input_size: int, output_size: int, act_func_type: str = "gelu_erf"):
        super().__init__()
        self.act = ACTIVATIONS[act_func_type]
        self.conv1 = nn.Conv1d(input_size, output_size, 3, padding=1)
        self.conv2 = nn.Conv1d(output_size, output_size, 3, stride=2, padding=1)

    def output_length(self, t: int) -> int:
        return conv_out_len(t, 3, 2, 1)

    def forward(self, x, mask):
        """x: [B, T, F]; mask: bool[B, T] → ([B, ceil(T/2), D], bool[B, ceil(T/2)])."""
        h = self.act(self.conv2(self.act(self.conv1(x.transpose(1, 2)))))
        return h.transpose(1, 2), mask[:, ::2]

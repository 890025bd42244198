"""Seeded weights, made on the device in one draw.

The benchmark makes the weights, not the port: one normal draw from a
``torch.Generator`` on the device covers every parameter, each slice scaled
by its kind, then rounded to the type the weights are served in. The same
tensors go to the port (copied into its parameters) and to the plain
reference, which reads them by the port's parameter names.
"""

from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    h = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def scale_of(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter by its name and shape: LayerNorm gains
    near 1, biases and other vectors small, matrices 1/sqrt(fan-in)."""
    if len(shape) == 1:
        if "norm" in name and name.endswith("weight"):
            return 1.0, 0.1
        return 0.0, 0.02
    fan_in = 1
    for d in shape[1:]:
        fan_in *= int(d)
    return 0.0, fan_in ** -0.5


def make_weights(shapes: dict, seed: int, device, dtype) -> dict:
    """name -> tensor of ``shapes`` (name -> shape), drawn from ``seed``."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        mean, std = scale_of(name, shape)
        out[name] = (flat[off:off + n].view(shape) * std + mean).to(dtype)
        off += n
    return out


def param_shapes(model: torch.nn.Module) -> dict:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's weights into the port's parameters."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the weights do not name the model's parameters: "
                         f"{sorted(set(params) ^ set(weights))[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])

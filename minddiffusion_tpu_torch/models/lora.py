"""LoRA adapters on the UNet's attention projections (port of
minddiffusion_tpu/models/attention.py `LoRADense` and
minddiffusion_tpu/models/lora.py).

`LoRALinear` is a `layers.Linear` with a rank-r additive adapter,
y = x W^T + b + (alpha / r) * (x A) B, A (in, r) ~ N(0, 0.02^2), B (r, out)
zero, so enabling LoRA changes nothing until B is trained. A and B are cast
to the input's dtype at use and the delta is added to the base output in
that dtype, as the JAX package does under dtype=bf16.

Under tp (parallel/tensor_parallel.py) lora_a and lora_b are split where
the JAX rule splits them, which is where the rule splits their layer
(parallel/mesh.shard_params refuses a rank that does not divide by tp):
on a column-parallel projection lora_a holds r / tp of the rank dim and
lora_b the rank's output features, so (x A) is gathered whole over the tp
ranks first (`column_delta`); on a row-parallel one lora_a holds the
rank's input rows and lora_b r / tp of the rank dim, so (x A) is reduced
whole over the tp ranks and the rank takes its block of it (`row_delta`).

The state-dict helpers work on flat LDM-named state dicts (the names
io/sd_weights.py produces): an adapter is the pair `<proj>.lora_a`,
`<proj>.lora_b` beside its base `<proj>.weight`.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from minddiffusion_tpu_torch.models.layers import Linear

LORA_SUFFIXES = (".lora_a", ".lora_b")


class LoRALinear(Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 rank: int = 4, alpha: float = 4.0):
        super().__init__(in_features, out_features, bias=bias)
        self.rank, self.alpha = rank, alpha
        self.lora_a = nn.Parameter(torch.randn(in_features, rank) * 0.02)
        self.lora_b = nn.Parameter(torch.zeros(rank, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        delta = x @ self.lora_a.to(x.dtype) @ self.lora_b.to(x.dtype)
        return super().forward(x) + delta * (self.alpha / self.rank)

    def column_delta(self, tp, xc: torch.Tensor) -> torch.Tensor:
        """The scaled delta of this rank's output features on a
        column-parallel layer; `xc` the input through `tp.copy`."""
        t = tp.copy(tp.gather(xc @ self.lora_a.to(xc.dtype)))
        return (t @ self.lora_b.to(xc.dtype)) * (self.alpha / self.rank)

    def row_delta(self, tp, h: torch.Tensor) -> torch.Tensor:
        """This rank's fp32 partial of the scaled delta on a row-parallel
        layer; `h` its block of the input features."""
        u = tp.reduce(h.float() @ self.lora_a.to(h.dtype).float()).to(h.dtype)
        return (tp.block(tp.copy(u), -1).float() @ self.lora_b.to(h.dtype).float()) * (
            self.alpha / self.rank)


def is_lora_name(name: str) -> bool:
    return name.endswith(LORA_SUFFIXES)


def merge_lora_state_dict(state_dict: Dict[str, torch.Tensor], rank: int = 4,
                          alpha: float = 4.0) -> Dict[str, torch.Tensor]:
    """Fold every adapter into its base weight, W + (alpha / r) (A B)^T, and
    drop the adapter entries: the result loads into the model built without
    LoRA and computes what the LoRA model computes (JAX `merge_lora_params`)."""
    scale = alpha / rank
    out = {k: v for k, v in state_dict.items() if not is_lora_name(k)}
    for name, a in state_dict.items():
        if name.endswith(".lora_a"):
            base = name[:-len(".lora_a")]
            delta = a.float() @ state_dict[base + ".lora_b"].float()
            w = state_dict[base + ".weight"]
            out[base + ".weight"] = (w.float() + scale * delta.T).to(w.dtype)
    return out


def extract_lora_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Only the adapter entries: the small LoRA checkpoint (JAX
    `extract_lora_params`)."""
    return {k: v for k, v in state_dict.items() if is_lora_name(k)}


def apply_lora_state_dict(state_dict: Dict[str, torch.Tensor],
                          adapters: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Overlay saved adapters on a LoRA model's full state dict (JAX
    `apply_lora_params`). Raises on an adapter name the state dict lacks."""
    unknown = sorted(set(adapters) - {k for k in state_dict if is_lora_name(k)})
    if unknown:
        raise KeyError(f"adapters without a LoRA site: {unknown[:5]}")
    return {**state_dict, **adapters}

"""Serving-time parameter cast (port of minddiffusion_tpu/utils/params.py
`cast_serving_params`).

The JAX rule casts the leaves named kernel, embedding, token_embedding,
positional_embedding, padding_embedding, lora_a and lora_b: the conv and
dense kernels and the lookup tables, which only ever enter the graph cast to
the compute dtype. Biases and norm scales stay fp32. In the port's LDM and
GLIDE names those are exactly the floating parameters of two or more
dimensions (a Linear, Conv or Embedding `.weight`, `positional_embedding`,
`padding_embedding`, `lora_a` / `lora_b`); every bias and norm parameter is
a vector.

For a model held with fp32 master weights under a bf16 `compute_dtype` (the
training form, `SDModels.create(param_dtype=torch.float32)`), the cast
changes no output bit: each such weight is rounded to the compute dtype at
use anyway. `SDModels.create(dtype=torch.bfloat16)` builds the inference
form directly (every weight but the norms' in bf16), so the serve CLI needs
no cast.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn


def serving_cast_names(module: nn.Module) -> List[str]:
    """The parameter names `cast_serving_params` casts."""
    return [name for name, p in module.named_parameters()
            if p.is_floating_point() and p.ndim >= 2]


def cast_serving_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast the heavy weights of `module` to `dtype` in place (the JAX
    function's leaf rule, module docstring); biases and norm parameters keep
    their dtype. Returns `module`. For inference: resume training only after
    casting back."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name in serving_cast_names(module):
            params[name].data = params[name].data.to(dtype)
    return module

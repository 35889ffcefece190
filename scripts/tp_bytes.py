"""The bytes the tensor-parallel collectives of one SD2 finetune step move
on a rank, counted on the CPU with meta tensors (no process group, no
card; the kernels' plain versions stand in, the same shapes): SD2 at full width, the pieces of tp `--tp` placed by
parallel/mesh.shard_params, one forward and backward of the loss from
latents (the VAE encode runs no tp collective), each collective of
parallel/tensor_parallel.TensorParallel counted by kind instead of run.

    python3 scripts/tp_bytes.py [--batch 4] [--size 512] [--tp 2]

Prints, per kind (the identity forward's all-reduce in the backward, the
row-parallel all-reduce, the all-gather of the sites whose heads tp does
not divide), the calls, the payload (the tensor entering the collective)
and the bytes a rank sends in a ring (all-reduce 2 (p - 1) / p of the
payload, all-gather p - 1 times its input); then what the whole
ff.net.2 moves as it is (its columns, the output and W2's gradient
all-reduced) and what gathering the FF features before it would move.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from minddiffusion_tpu_torch import ops  # noqa: E402
from minddiffusion_tpu_torch.models.attention import FeedForward  # noqa: E402
from minddiffusion_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from minddiffusion_tpu_torch.parallel.tensor_parallel import TensorParallel  # noqa: E402
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels  # noqa: E402

COUNTS = collections.defaultdict(lambda: [0, 0])     # kind -> [calls, payload bytes]


def nbytes(t: torch.Tensor, dtype=None) -> int:
    return t.numel() * (dtype or t.dtype).itemsize


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        COUNTS["copy: all-reduce in the backward (fp32)"][0] += 1
        COUNTS["copy: all-reduce in the backward (fp32)"][1] += nbytes(g, torch.float32)
        return g


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        COUNTS["reduce: row-parallel all-reduce (fp32)"][0] += 1
        COUNTS["reduce: row-parallel all-reduce (fp32)"][1] += nbytes(x, torch.float32)
        return x.float().clone()

    @staticmethod
    def backward(ctx, g):
        return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        COUNTS["gather: all-gather of q, k, v (its input)"][0] += 1
        COUNTS["gather: all-gather of q, k, v (its input)"][1] += nbytes(x)
        ctx.n = x.shape[-1]
        return torch.cat([x] * size, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, 0, ctx.n).contiguous(), None


class CountingTP(TensorParallel):
    def copy(self, x):
        return _Copy.apply(x)

    def reduce(self, x):
        return _Reduce.apply(x)

    def gather(self, x):
        return _Gather.apply(x, self.size)


class StandInMesh:
    mesh_dim_names = mesh_lib.AXES

    def __init__(self, tp: int):
        self.shape = (1, 1, tp)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--tp", type=int, default=2)
    args = p.parse_args()
    models = SDModels.create(family="sd2", dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="meta")
    net = {"unet": models.unet, "text": models.text_encoder}
    tp = mesh_lib.shard_params(net, StandInMesh(args.tp))
    counting = CountingTP(None, 0, args.tp, tp.pieces)
    ff_features = []
    for module in net.values():
        for m in module.modules():
            if hasattr(type(m), "tp"):
                m.tp = counting
            if isinstance(m, FeedForward):
                m.register_forward_hook(lambda mod, inp, out: ff_features.append(
                    (inp[0].shape[:-1].numel(), mod.net[2].in_features,
                     mod.net[2].out_features)))
    h = args.size // 8
    z = torch.empty(args.batch, h, h, 4, device="meta")
    t = torch.zeros(args.batch, dtype=torch.long, device="meta")
    tokens = torch.zeros(args.batch, 77, dtype=torch.long, device="meta")
    for module in net.values():
        module.requires_grad_(True)
    with ops.plain_reference():         # the kernels' plain versions take meta tensors
        eps = models.unet(z, t, models.text_encoder(tokens))
        eps.float().square().mean().backward()
    p_ = args.tp
    print(f"SD2 finetune {args.size}^2 b{args.batch} at tp {p_}: {len(tp.pieces)} pieces, "
          "one forward and backward of the UNet and CLIP-H, a rank:")
    wire = 0
    for kind, (calls, payload) in sorted(COUNTS.items()):
        sent = payload * (p_ - 1) if kind.startswith("gather") else payload * 2 * (p_ - 1) / p_
        wire += sent
        print(f"  {kind}: {calls} calls, payload {payload / 1e9:.4f} GB, "
              f"sent {sent / 1e9:.4f} GB")
    print(f"  in all: {sum(c for c, _ in COUNTS.values())} collectives, "
          f"sent {wire / 1e9:.4f} GB a rank a step")
    ours = sum((m * c + f * c) * 4 * 2 * (p_ - 1) / p_ for m, f, c in ff_features)
    other = sum(m * f * 2 / p_ * (p_ - 1) for m, f, _ in ff_features)
    print(f"  ff.net.2 (whole) at its {len(ff_features)} sites: this rank's columns, the "
          f"fp32 output all-reduced and W2's gradient all-reduced: sent {ours / 1e9:.4f} GB "
          f"(in the totals above); the FF features (bf16) all-gathered instead, ff.net.2 "
          f"and its gradient repeated on every rank: {other / 1e9:.4f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

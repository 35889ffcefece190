"""Export SD weights to an LDM-layout .safetensors file (the flags of
minddiffusion_tpu's export_weights CLI, plus --device, cuda by default).

    python -m minddiffusion_tpu_torch.cli.export_weights --family sd2 \\
        --ckpt sd2-finetuned.ckpt --out sd2-finetuned.safetensors
    python -m minddiffusion_tpu_torch.cli.export_weights --family wukong \\
        --ckpt base.ckpt --lora_ckpt runs/lora/ckpt_00000800.pt --merge_lora \\
        --out wukong-lora-merged.safetensors

--ckpt is read as the other CLIs read it (`common.read_checkpoint`:
.safetensors, torch or MindSpore .ckpt; orbax directories are refused).
--lora_ckpt is an adapter checkpoint as the port's LoRA training saves it
(io/checkpoints.py: the adapters only, LDM names), laid over the base.
The LoRA model is built at --lora_rank with scale --lora_alpha / --lora_rank,
so adapters of another rank fail to load. --merge_lora folds the adapters
into their base weights at the model's own rank and alpha
(`models.lora.merge_lora_state_dict`); without it the adapters are reported
and left out, since LDM has no names for them. The weights are held in fp32
(fp32 masters under bf16 compute on the card) and written in fp32.
--height / --width size only the JAX CLI's abstract init, which the port
does not build: they are taken for one command line across the two CLIs, and
any value but 512 is refused.
"""
from __future__ import annotations

import argparse

import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="sd2", choices=["sd2", "wukong"])
    p.add_argument("--ckpt", required=True,
                   help=".safetensors / torch .ckpt / MindSpore .ckpt (LDM names)")
    p.add_argument("--lora_ckpt", default=None,
                   help="LoRA adapter checkpoint (the port's training output) to overlay")
    p.add_argument("--merge_lora", action="store_true",
                   help="fold LoRA deltas into the base weights before export")
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--lora_alpha", type=float, default=4.0)
    p.add_argument("--out", required=True, help="output .safetensors path")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--debug_tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    parser = build_argparser()
    args = parser.parse_args(argv)
    if (args.height, args.width) != (512, 512):
        parser.error("--height / --width size the JAX CLI's abstract init; the port's export "
                     "builds none and takes only 512")

    from minddiffusion_tpu_torch.cli import common
    from minddiffusion_tpu_torch.io import sd_weights

    device = common.resolve_device(args.device)
    enable_lora = bool(args.lora_ckpt or args.merge_lora)
    models = common.build_sd(args.family, "bf16" if device.type == "cuda" else "fp32",
                             device, tiny=args.debug_tiny, ckpt_path=args.ckpt,
                             param_dtype=torch.float32, enable_lora=enable_lora,
                             lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
    if args.lora_ckpt:
        from minddiffusion_tpu_torch.io.checkpoints import load_checkpoint, merge_params

        state = merge_params(models.state_dict(), load_checkpoint(args.lora_ckpt))
        models.load_state_dict({k: v.float().cpu().numpy() for k, v in state.items()})
    if args.merge_lora:
        from minddiffusion_tpu_torch.models.lora import LoRALinear, merge_lora_state_dict

        (rank, alpha), = {(m.rank, m.alpha) for m in models.unet.modules()
                          if isinstance(m, LoRALinear)}
        merged = merge_lora_state_dict(models.state_dict(), rank=rank, alpha=alpha)
        sd, report = {k: v.float().cpu().numpy() for k, v in merged.items()}, []
    else:
        sd, report = sd_weights.export_sd_checkpoint(models)
    for line in report[:20]:
        print(f"[export] {line}")
    if len(report) > 20:
        print(f"[export] ... {len(report) - 20} more")
    sd_weights.save_safetensors(sd, args.out, metadata={"format": "pt"})
    print(f"[export] wrote {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()

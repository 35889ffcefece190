"""The program under test for the SD configurations, built through its
normal entry points (`SDModels.create` with the configuration's widths, a
strict load of the LDM-named weights), and the seeded inputs both sides
are given."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench.harness import sub_seed
from portbench.reference.models import PREFIX

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def port_configs(config: dict) -> dict:
    """The port's config objects for the configuration file's widths."""
    from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
    from minddiffusion_tpu_torch.models.unet import UNetConfig
    from minddiffusion_tpu_torch.models.vae import VAEConfig

    u, t, v = config["unet"], config["text"], config["vae"]
    unet = UNetConfig(
        in_channels=u["in_channels"], model_channels=u["model_channels"],
        out_channels=u["out_channels"], num_res_blocks=u["num_res_blocks"],
        attention_resolutions=tuple(u["attention_resolutions"]),
        channel_mult=tuple(u["channel_mult"]), num_heads=u["num_heads"],
        num_head_channels=u["num_head_channels"], transformer_depth=u["transformer_depth"],
        context_dim=u["context_dim"], use_linear_in_transformer=u["use_linear_in_transformer"],
        attn_impl=config.get("attn_impl"))
    text = CLIPTextConfig(vocab_size=t["vocab_size"], width=t["width"], layers=t["layers"],
                          heads=t["heads"], context_length=t["context_length"],
                          use_quick_gelu=t["act"] == "quick_gelu")
    vae = VAEConfig(in_channels=v["in_channels"], out_channels=v["out_channels"], ch=v["ch"],
                    ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"],
                    z_channels=v["z_channels"], embed_dim=v["embed_dim"])
    return dict(unet_config=unet, text_config=text, vae_config=vae)


def port_models(config: dict, state: Dict[str, torch.Tensor], device,
                param_dtype: Optional[torch.dtype] = None):
    """SDModels at the configuration's widths holding `state` (strict)."""
    from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

    s = config["schedule"]
    models = SDModels.create(family=config["family"], dtype=DTYPES[config["dtype"]],
                             attn_impl=config.get("attn_impl"), device=device,
                             param_dtype=param_dtype, timesteps=s["timesteps"],
                             linear_start=s["linear_start"], linear_end=s["linear_end"],
                             **port_configs(config))
    with torch.no_grad():
        for kind, module in models.modules().items():
            prefix = PREFIX[kind]
            module.load_state_dict({k[len(prefix):]: v for k, v in state.items()
                                    if k.startswith(prefix)}, strict=True)
    return models


def prompt_tokens(config: dict, traffic: dict, seed: int, key, batch: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cond, uncond) token ids (batch, L) drawn on the device: cond is
    bos, a seeded number of seeded ids, eos, then pad; uncond is the empty
    prompt (bos, eos, pad). The stated stand-in for a tokenizer, whose
    vocabulary the repository does not hold."""
    tok = config["tokens"]
    length = config["text"]["context_length"]
    lo, hi = traffic["prompt_tokens"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "tokens", key))
    n = torch.randint(lo, hi + 1, (batch, 1), generator=gen, device=device)
    ids = torch.randint(tok["low"], tok["high"], (batch, length), generator=gen, device=device)
    pos = torch.arange(length, device=device)[None]
    pad = torch.full_like(ids, tok["pad"])
    cond = torch.where(pos == 0, tok["bos"], torch.where(
        pos <= n, ids, torch.where(pos == n + 1, tok["eos"], pad)))
    uncond = torch.where(pos == 0, tok["bos"], torch.where(pos == 1, tok["eos"], pad))
    return cond, uncond.expand(batch, -1).contiguous()


def latent_noise(config: dict, traffic: dict, seed: int, key, batch: int, device) -> torch.Tensor:
    f = 2 ** (len(config["vae"]["ch_mult"]) - 1)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "noise", key))
    return torch.randn((batch, traffic["height"] // f, traffic["width"] // f,
                        config["vae"]["embed_dim"]), generator=gen, device=device)

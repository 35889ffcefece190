"""Weight io and export against the JAX package, on the CPU: safetensors
and MindSpore .ckpt files written by one package and read by the other
(bitwise, BF16 included where a writer has it), and the export CLI in both
directions on torch_parity's tiny SD2 pair (the port's --debug_tiny SD2 is
the same architecture): a JAX export loads through the port's `build_sd`
and gives JAX's eps, and the port's export loads through the JAX
`load_params`; --lora_ckpt / --merge_lora against the LoRA model itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.cli.common import load_params as jax_load_params
from minddiffusion_tpu.io import ms_checkpoint as jax_ms
from minddiffusion_tpu.io import sd_weights as jax_sw
from minddiffusion_tpu_torch.cli import common
from minddiffusion_tpu_torch.cli.export_weights import main as export_main
from minddiffusion_tpu_torch.io import ms_checkpoint, sd_weights
from minddiffusion_tpu_torch.io.checkpoints import save_checkpoint
from minddiffusion_tpu_torch.models.lora import extract_lora_state_dict, is_lora_name

EPS_TOL = 1e-5     # of max |eps|: the same fp32 model in two frameworks


def arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w.f32": rng.standard_normal((3, 4)).astype(np.float32),
            "w.f16": rng.standard_normal((5,)).astype(np.float16),
            "w.f64": rng.standard_normal((2, 2)),
            "i.i64": np.arange(6, dtype=np.int64).reshape(2, 3),
            "i.i32": np.arange(3, dtype=np.int32), "i.u8": np.arange(4, dtype=np.uint8),
            "b.bool": np.array([True, False])}


def test_safetensors_jax_writes_port_reads_bitwise(tmp_path):
    path = str(tmp_path / "jax.safetensors")
    jax_sw.save_safetensors(arrays(0), path, metadata={"format": "pt"})
    ours, theirs = sd_weights.load_safetensors(path), jax_sw.load_safetensors(path)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_safetensors_port_writes_jax_reads_bitwise_bf16_included(tmp_path):
    """The two writers give the same bytes for the same arrays; the port also
    writes torch tensors, bf16 as BF16, which the JAX reader decodes (through
    ml_dtypes) to the values the port's reader gives (through torch)."""
    a, b = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    sd_weights.save_safetensors(arrays(1), a, metadata={"format": "pt"})
    jax_sw.save_safetensors(arrays(1), b, metadata={"format": "pt"})
    assert open(a, "rb").read() == open(b, "rb").read()
    bf16 = torch.randn(4, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tensors = {"t.bf16": bf16, "t.f32": torch.randn(3), "t.i64": torch.arange(5)}
    sd_weights.save_safetensors(tensors, a)
    ours, theirs = sd_weights.load_safetensors(a), jax_sw.load_safetensors(a)
    np.testing.assert_array_equal(ours["t.bf16"], bf16.float().numpy())
    for k in tensors:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype


def test_ms_checkpoint_both_ways(tmp_path):
    params = {k: v for k, v in arrays(2).items() if k not in ("w.f64", "i.u8", "b.bool")}
    params["first_stage_model.encoder.norm_out.gamma"] = np.ones(4, np.float32)
    a, b = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    ms_checkpoint.save_ms_checkpoint(a, params)
    jax_ms.save_ms_checkpoint(b, params)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        ours, theirs = ms_checkpoint.load_ms_checkpoint(path), jax_ms.load_ms_checkpoint(path)
        assert ours.keys() == theirs.keys() == params.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
            np.testing.assert_array_equal(ours[k], params[k].astype(np.float32), err_msg=k)
    names = ms_checkpoint.ms_to_ldm_names(ms_checkpoint.load_ms_checkpoint(a))
    assert set(names) == set(jax_ms.ms_to_ldm_names(jax_ms.load_ms_checkpoint(a)))
    assert "first_stage_model.encoder.norm_out.weight" in names


@pytest.fixture(scope="module")
def pair():
    jm = tp.jax_models()
    params = tp.jax_params(jm, seed=5)
    apply = jax.jit(lambda p, x, t, c: jm.unet.apply(p, x, t, c))
    return jm, params, apply


def unet_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 4)).astype(np.float32), np.array([981, 41], np.int32),
            rng.standard_normal((2, 77, 32)).astype(np.float32))


def port_eps(models) -> np.ndarray:
    x, t, ctx = unet_inputs()
    with torch.no_grad():
        return models.unet(tp.t(x), tp.t(t).long(), tp.t(ctx)).numpy()


def test_export_cli_jax_to_port_and_back(pair, tmp_path, capsys):
    jm, params, apply = pair
    x, t, ctx = map(jnp.asarray, unet_inputs())
    ref = np.asarray(apply(params["unet"], x, t, ctx))
    sd, report = jax_sw.export_sd_checkpoint(params, jm.unet.config)
    assert not report
    src, out = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_sw.save_safetensors(sd, src, metadata={"format": "pt"})

    # JAX export -> the port: build_sd reads it, and eps is JAX's
    models = common.build_sd("sd2", "fp32", torch.device("cpu"), tiny=True, ckpt_path=src)
    got = port_eps(models)
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= EPS_TOL * np.abs(ref).max()

    # the port's export CLI: the same tensors out, and JAX load_params reads them
    export_main(["--family", "sd2", "--ckpt", src, "--out", out, "--debug_tiny",
                 "--device", "cpu"])
    assert f"wrote {len(sd)} tensors" in capsys.readouterr().out
    back = sd_weights.load_safetensors(out)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    jparams = jax_load_params(jm, out, 64, 64)
    np.testing.assert_array_equal(np.asarray(apply(jparams["unet"], x, t, ctx)), ref)


def test_export_cli_reads_torch_and_mindspore_checkpoints(tmp_path):
    models = common.build_sd("sd2", "fp32", torch.device("cpu"), tiny=True, seed=1)
    sd = {k: v.numpy() for k, v in models.state_dict().items()}
    pt, ms = str(tmp_path / "w.ckpt"), str(tmp_path / "ms.ckpt")
    torch.save({"state_dict": models.state_dict()}, pt)
    ms_checkpoint.save_ms_checkpoint(ms, sd)
    for path in (pt, ms):
        out = str(tmp_path / "out.safetensors")
        export_main(["--ckpt", path, "--out", out, "--debug_tiny", "--device", "cpu"])
        back = sd_weights.load_safetensors(out)
        assert back.keys() == sd.keys()
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    with pytest.raises(SystemExit, match="orbax"):
        common.read_checkpoint(str(tmp_path))


def test_export_cli_merge_lora(tmp_path, capsys):
    """--lora_ckpt (the adapters as the port's LoRA training saves them) and
    --merge_lora: the merged file, loaded without LoRA, gives the LoRA
    model's eps; without --merge_lora the adapters are reported, not
    written."""
    cpu = torch.device("cpu")
    base = common.build_sd("sd2", "fp32", cpu, tiny=True, seed=2)
    base_path = str(tmp_path / "base.safetensors")
    sd_weights.save_safetensors(base.state_dict(), base_path)
    lora = common.build_sd("sd2", "fp32", cpu, tiny=True, ckpt_path=base_path,
                           enable_lora=True, seed=3)
    gen = torch.Generator().manual_seed(4)
    adapters = {k: torch.randn(v.shape, generator=gen) * 0.1
                for k, v in extract_lora_state_dict(lora.state_dict()).items()}
    assert adapters
    save_checkpoint(str(tmp_path / "ckpt_00000003.pt"), adapters)
    lora.load_state_dict({k: v.numpy() for k, v in {**lora.state_dict(), **adapters}.items()})
    ref = port_eps(lora)
    assert np.abs(ref - port_eps(base)).max() > 1e-3          # the adapters do something

    merged = str(tmp_path / "merged.safetensors")
    export_main(["--ckpt", base_path, "--lora_ckpt", str(tmp_path / "ckpt_00000003.pt"),
                 "--merge_lora", "--out", merged, "--debug_tiny", "--device", "cpu"])
    out = common.build_sd("sd2", "fp32", cpu, tiny=True, ckpt_path=merged)
    assert not any(is_lora_name(k) for k in sd_weights.load_safetensors(merged))
    got = port_eps(out)
    assert np.abs(got - ref).max() <= EPS_TOL * np.abs(ref).max()

    capsys.readouterr()
    unmerged = str(tmp_path / "unmerged.safetensors")
    export_main(["--ckpt", base_path, "--lora_ckpt", str(tmp_path / "ckpt_00000003.pt"),
                 "--out", unmerged, "--debug_tiny", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[export] not exported: model.diffusion_model." in printed
    assert set(sd_weights.load_safetensors(unmerged)) == set(base.state_dict())


def test_export_cli_merges_at_the_lora_rank_and_alpha(tmp_path):
    """--lora_rank 8 --lora_alpha 16 builds the LoRA model at rank 8 with
    scale 2, and the merge folds its adapters at that scale; rank-4
    adapters do not load into it."""
    cpu = torch.device("cpu")
    base = common.build_sd("sd2", "fp32", cpu, tiny=True, seed=2)
    base_path = str(tmp_path / "base.safetensors")
    sd_weights.save_safetensors(base.state_dict(), base_path)
    lora = common.build_sd("sd2", "fp32", cpu, tiny=True, ckpt_path=base_path,
                           enable_lora=True, seed=3, lora_rank=8, lora_alpha=16.0)
    gen = torch.Generator().manual_seed(5)
    adapters = {k: torch.randn(v.shape, generator=gen) * 0.1
                for k, v in extract_lora_state_dict(lora.state_dict()).items()}
    assert all(8 in v.shape for v in adapters.values())
    save_checkpoint(str(tmp_path / "ckpt_00000008.pt"), adapters)
    lora.load_state_dict({k: v.numpy() for k, v in {**lora.state_dict(), **adapters}.items()})
    ref = port_eps(lora)
    merged = str(tmp_path / "merged.safetensors")
    flags = ["--ckpt", base_path, "--lora_ckpt", str(tmp_path / "ckpt_00000008.pt"),
             "--merge_lora", "--out", merged, "--debug_tiny", "--device", "cpu"]
    export_main(flags + ["--lora_rank", "8", "--lora_alpha", "16"])
    got = port_eps(common.build_sd("sd2", "fp32", cpu, tiny=True, ckpt_path=merged))
    assert np.abs(got - ref).max() <= EPS_TOL * np.abs(ref).max()
    with pytest.raises(RuntimeError, match="size mismatch"):
        export_main(flags)                                  # rank 4 by default


@pytest.mark.parametrize("flag", ["--height", "--width"])
def test_export_cli_refuses_sizes_it_cannot_use(tmp_path, flag):
    with pytest.raises(SystemExit):
        export_main(["--ckpt", str(tmp_path / "x.ckpt"), "--out", str(tmp_path / "y"),
                     "--device", "cpu", flag, "768"])


def test_export_cli_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_main(["--ckpt", str(tmp_path / "x.ckpt"), "--out", str(tmp_path / "y")])

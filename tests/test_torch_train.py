"""SD training in the port (`train/`, `models/lora.py`, LoRA in
`io/sd_weights.py`) against the JAX package's (`minddiffusion_tpu/train`,
`models/lora.py`) on the tiny configs of tests/torch_parity.py, fp32 on the
CPU.

The train step runs 3 steps of finetune (SD2-tiny, CFG text dropout 0.5),
LoRA (SD1-tiny) and DreamBooth (SD2-tiny) in both packages, the port fed
the JAX step's own draws (t, noise, the posterior's noise, the dropout
mask) rebuilt from its keys: fold_in(rng, step), split into (r1, r2), r1
(and r2 for the DreamBooth reg loss) split into (enc, t, noise, drop).
Warmup 1 step, so the first update has lr 0 (optax reads the schedule at
the update count, from 0).

The JAX side runs `make_train_step`'s own pieces, each jitted: its loss
(`diffusion_loss`, the DreamBooth sum) under `value_and_grad`, the finite
guard, `TrainState.apply_gradients` (the optax chain). XLA:CPU takes 2-3
minutes to compile the whole step as one program (its tree-wide `where`
over the state), and 15 s for the pieces.

The UNet is the tiny one at model_channels 64: at 32, every GroupNorm
group holds one channel, so a per-channel shift before a norm (a conv or
emb_layers bias) has a gradient of exactly zero in exact arithmetic, both
packages return rounding noise there, and AdamW turns noise of any size
into steps of about lr, which no tolerance on the params can hold.

Tolerances: loss and grad_norm 1e-5 relative (fp32, the same math in
another summation order); params after the steps 1e-3 * lr * steps
absolute (an AdamW update moves a param by about lr per step).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity as tp
from minddiffusion_tpu.models import lora as jax_lora
from minddiffusion_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from minddiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from minddiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from minddiffusion_tpu.pipelines.stable_diffusion import SDModels as JaxSDModels
from minddiffusion_tpu.train import lr_schedules as jax_lr
from minddiffusion_tpu.train import optim as jax_optim
from minddiffusion_tpu.train import trainer as jax_trainer
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager, merge_params
from minddiffusion_tpu_torch.io.sd_weights import state_dict_from_jax
from minddiffusion_tpu_torch.models import layers, lora
from minddiffusion_tpu_torch.models.clip import CLIPTextConfig
from minddiffusion_tpu_torch.models.unet import UNetConfig
from minddiffusion_tpu_torch.models.vae import VAEConfig
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels
from minddiffusion_tpu_torch.train import lr_schedules, optim, trainer

SIZE, BATCH, STEPS = 64, 2, 3
LR = 1e-3
CASES = {   # mode: (family, LoRA, DreamBooth, cond_dropout)
    "finetune": ("sd2", False, False, 0.5),
    "lora": ("wukong", True, False, 0.0),
    "dreambooth": ("sd2", False, True, 0.0),
}


def unet_kw(family: str, use_lora: bool) -> dict:
    return dict(tp.UNET_KW, **tp.FAMILY_UNET_KW[family], enable_lora=use_lora,
                model_channels=64)


def build(family: str, use_lora: bool, seed: int = 0):
    ukw = unet_kw(family, use_lora)
    jm = JaxSDModels.create(
        family=family, dtype=jnp.float32, enable_lora=use_lora,
        unet_config=JaxUNetConfig(**ukw), vae_config=JaxVAEConfig(**tp.VAE_KW),
        text_config=JaxCLIPConfig(use_quick_gelu=family != "sd2", **tp.CLIP_KW))
    params = tp.jax_params(jm, seed, size=SIZE)
    pm = SDModels.create(
        family=family, dtype=torch.float32, device="cpu", param_dtype=torch.float32,
        unet_config=UNetConfig(**ukw), vae_config=VAEConfig(**tp.VAE_KW),
        text_config=CLIPTextConfig(use_quick_gelu=family != "sd2", **tp.CLIP_KW))
    pm.load_state_dict(state_dict_from_jax(params, jm.unet.config))
    return jm, params, pm


def batch(seed: int, dreambooth: bool) -> dict:
    rng = np.random.default_rng(seed)
    out = {"image": rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32),
           "tokens": rng.integers(0, 21128, (BATCH, 77)).astype(np.int32)}
    if dreambooth:
        out["reg_image"] = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
        out["reg_tokens"] = rng.integers(0, 21128, (BATCH, 77)).astype(np.int32)
    return out


def jax_draws(rng, step: int, cond_dropout: float, dreambooth: bool):
    """The draws of the JAX step at `step` (trainer.py:101,143,161)."""
    def loss_draws(key):
        k_enc, k_t, k_noise, k_drop = jax.random.split(key, 4)
        lat = (BATCH, SIZE // 8, SIZE // 8, 4)
        d = {"t": jax.random.randint(k_t, (BATCH,), 0, 1000),
             "noise": jax.random.normal(k_noise, lat, jnp.float32),
             "enc_noise": jax.random.normal(k_enc, lat, jnp.float32)}
        if cond_dropout > 0:
            d["keep"] = jax.random.bernoulli(k_drop, 1.0 - cond_dropout, (BATCH, 1, 1))[:, 0, 0]
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

    r1, r2 = jax.random.split(jax.random.fold_in(rng, step))
    return (loss_draws(r1), loss_draws(r2)) if dreambooth else loss_draws(r1)


def configs(trainable: str, cond_dropout: float):
    kw = dict(start_lr=LR, end_lr=LR / 10, warmup_steps=1, decay_steps=10,
              trainable=trainable, cond_dropout=cond_dropout)
    return jax_trainer.TrainConfig(**kw), trainer.TrainConfig(**kw)


def jax_step_parts(jm, config, dreambooth: bool):
    """make_train_step's loss (minddiffusion_tpu/train/trainer.py:150-165)
    under a jitted value_and_grad, and a jitted apply_gradients."""
    def loss_fn(params, batch, rng):
        r1, r2 = jax.random.split(rng)
        loss, metrics = jax_trainer.diffusion_loss(
            jm, params, batch.get("image"), batch["tokens"], r1,
            cond_dropout=config.cond_dropout, latent=batch.get("latent"))
        if dreambooth:
            reg_loss, _ = jax_trainer.diffusion_loss(
                jm, params, batch.get("reg_image"), batch["reg_tokens"], r2,
                latent=batch.get("reg_latent"))
            metrics["train_loss"] = loss
            metrics["reg_loss"] = reg_loss
            loss = loss + config.prior_loss_weight * reg_loss
            metrics["loss"] = loss
        return loss, metrics

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    apply = jax.jit(lambda state, grads: state.apply_gradients(grads))

    def step(state, batch, rng):
        rng = jax.random.fold_in(rng, state.step)
        (_, metrics), grads = grad(state.params, batch, rng)
        grads = jax.device_get(grads)
        finite = all(np.isfinite(g).all() for g in jax.tree.leaves(grads))
        if finite:
            state = apply(state, grads).replace(step=state.step)
        else:
            grads = jax.tree.map(np.zeros_like, grads)
        metrics = dict(jax.device_get(metrics), grads_finite=float(finite),
                       grad_norm=float(optax.global_norm(grads)))
        return state.replace(step=state.step + 1), metrics

    return step


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Both packages after STEPS steps of one mode, with their metrics."""
    family, use_lora, dreambooth, cond_dropout = CASES[request.param]
    jm, params, pm = build(family, use_lora)
    jcfg, pcfg = configs("lora" if use_lora else "unet", cond_dropout)
    b = batch(1, dreambooth)
    rng = jax.random.PRNGKey(0)
    jstate = jax_trainer.create_train_state(jm, params, jcfg)
    jstep = jax_step_parts(jm, jcfg, dreambooth)
    pstate = trainer.create_train_state(pm, pcfg)
    pstep = trainer.make_train_step(pcfg, dreambooth=dreambooth)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pb = {k: torch.from_numpy(v) for k, v in b.items()}
    jmetrics, pmetrics = [], []
    for i in range(STEPS):
        jstate, m = jstep(jstate, jb, rng)
        jmetrics.append(m)
        pmetrics.append({k: v.item() for k, v in
                         pstep(pstate, pb, 0, jax_draws(rng, i, cond_dropout,
                                                        dreambooth)).items()})
    return dict(mode=request.param, jm=jm, params=params, jstate=jstate, pstate=pstate,
                jmetrics=jmetrics, pmetrics=pmetrics)


def test_train_steps_match_jax(run):
    for jm_, pm_ in zip(run["jmetrics"], run["pmetrics"]):
        assert set(pm_) == set(jm_)
        for k in ("loss", "grad_norm", "mse_t_mean", "train_loss", "reg_loss"):
            if k in jm_:
                np.testing.assert_allclose(pm_[k], float(jm_[k]), rtol=1e-5, err_msg=k)
        assert pm_["grads_finite"] == float(jm_["grads_finite"]) == 1.0
    assert run["pstate"].step == int(run["jstate"].step) == STEPS
    jparams = jax.tree.map(np.asarray, jax.device_get(run["jstate"].params))
    ref = state_dict_from_jax(jparams, run["jm"].unet.config)
    got = run["pstate"].models.state_dict()
    assert set(got) == set(ref)
    moved = 0
    for name, r in ref.items():
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, r, atol=1e-3 * LR * STEPS, rtol=0, err_msg=name)
        moved += not np.array_equal(r, state_dict_from_jax(run["params"], run["jm"].unet.config)[name]) \
            if name.endswith(".lora_a") else 0
    if run["mode"] == "lora":
        assert moved > 0
        before = state_dict_from_jax(run["params"], run["jm"].unet.config)
        for name, r in ref.items():    # only the adapters moved
            assert lora.is_lora_name(name) or np.array_equal(r, before[name]), name


def test_masks_match_jax():
    jm, params, pm = build("wukong", True)
    named = optim.named_parameters(pm.modules())
    shapes = jax.tree.map(np.shape, params)

    def mapped(mask):
        full = jax.tree.map(lambda m, s: np.full(s, float(m), np.float32), mask, shapes)
        sd = state_dict_from_jax(full, jm.unet.config)
        return {k for k, v in sd.items() if v.all()}

    assert optim.decay_names(named) == mapped(jax_optim.decay_mask(params))
    for mode in optim.TRAINABLE_MODES:
        assert optim.trainable_names(named, mode) == mapped(
            jax_optim.trainable_mask(params, mode)), mode


@pytest.mark.parametrize("cosine", [True, False])
def test_lr_schedule_matches_jax(cosine):
    warm, decay = 10, 100
    ours = lr_schedules.warmup_then_decay(1e-4, 1e-6, warm, decay, power=2.0,
                                          use_cosine=cosine)
    ref = jax_lr.warmup_then_decay(1e-4, 1e-6, warm, decay, power=2.0, use_cosine=cosine)
    for step in (0, 1, warm - 1, warm, 50, decay, decay + 7):
        np.testing.assert_allclose(ours(step).item(), float(ref(step)), rtol=1e-6)
        assert ours(torch.tensor(step)).item() == ours(step).item()
    assert ours(0).item() == 0.0
    no_warm = lr_schedules.warmup_then_decay(1e-4, 1e-6, 0, decay)
    assert no_warm(0).item() == pytest.approx(1e-4)


@pytest.mark.parametrize("needs_grad", ["x", "weight", "bias", "gn"])
def test_gated_conv_takes_the_training_route_when_any_input_needs_grad(monkeypatch,
                                                                      needs_grad):
    """A Winograd-gated conv records for autograd, through the training
    route, when any of x, the weight, the bias or the GN affine requires
    grad; under no_grad it takes the inference route."""
    calls = []
    route = layers.winograd.conv3x3_winograd_ad
    monkeypatch.setattr(layers.winograd, "conv3x3_winograd_ad",
                        lambda *a, **k: calls.append(1) or route(*a, **k))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 12, 12, 512)).astype(np.float32))
    w = torch.from_numpy(0.02 * rng.standard_normal((8, 512, 3, 3)).astype(np.float32))
    b = torch.zeros(8)
    gn = (torch.ones(1, 512), torch.zeros(1, 512))
    dict(x=x, weight=w, bias=b, gn=gn[1])[needs_grad].requires_grad_(True)
    y = layers.conv3x3_dispatch(x, w, b, gn=gn)
    assert calls == [1] and y.grad_fn is not None
    with torch.no_grad():
        layers.conv3x3_dispatch(x, w, b, gn=gn)
    assert calls == [1]


def test_adamw_takes_gradients_in_any_memory_order():
    """A conv weight's gradient comes back channels-last from an NHWC conv:
    the update must equal the one from the same gradient in the weight's
    own (contiguous) memory order."""
    rng = np.random.default_rng(6)
    w0 = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    out = []
    for grad in (g, g.contiguous(memory_format=torch.channels_last)):
        name = "model.diffusion_model.conv.weight"
        p = torch.nn.Parameter(w0.clone())
        opt = optim.AdamW({name: p}, lambda count: torch.tensor(1e-2), weight_decay=0.1)
        for _ in range(2):
            opt.step({name: grad}, torch.tensor(True))
        out.append(p.detach())
    assert not out[0].equal(w0) and torch.equal(out[0], out[1])


def test_finite_guard_keeps_the_state():
    """A NaN batch leaves the params, both moments and the count as they
    were; the step still advances and grad_norm reads 0."""
    _, _, pm = build("sd2", False)
    _, pcfg = configs("unet", 0.0)
    state = trainer.create_train_state(pm, pcfg)
    step = trainer.make_train_step(pcfg)
    good = {k: torch.from_numpy(v) for k, v in batch(2, False).items()}
    step(state, good, 0)
    step(state, good, 0)
    opt = state.optimizer

    def adam_state():       # params, both moments and torch's step count
        st = opt.torch_optimizer.state
        return [{n: p for n, p in opt.params.items()}] + [
            {n: st[p][key] for n, p in opt.params.items()}
            for key in ("exp_avg", "exp_avg_sq", "step")]

    before = [{n: t.detach().clone() for n, t in d.items()} for d in adam_state()]
    count = opt.count.clone()
    bad = dict(good, image=good["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    metrics = step(state, bad, 0)
    assert metrics["grads_finite"].item() == 0.0 and metrics["grad_norm"].item() == 0.0
    assert not np.isfinite(metrics["loss"].item())
    assert state.step == 3 and opt.count.item() == count.item() == 2
    for now, then in zip(adam_state(), before):
        for n in then:
            assert torch.equal(now[n], then[n]), n
    assert step(state, good, 0)["grads_finite"].item() == 1.0 and opt.count.item() == 3


def test_lora_merge_extract_apply_match_jax(tmp_path):
    jm, params, pm = build("wukong", True, seed=3)
    sd = state_dict_from_jax(params, jm.unet.config)
    plain_cfg = jm.unet.config.__class__(**{**jm.unet.config.__dict__, "enable_lora": False})
    merged_ref = state_dict_from_jax(jax_lora.merge_lora_params(params), plain_cfg)
    merged = lora.merge_lora_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert set(merged) == set(merged_ref)
    for k, v in merged_ref.items():
        np.testing.assert_allclose(merged[k].numpy(), v, atol=1e-6, err_msg=k)
    adapters = lora.extract_lora_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ref_ad = jax_lora.extract_lora_params(params)
    assert len(adapters) == len(jax.tree.leaves(ref_ad)) > 0
    assert all(lora.is_lora_name(k) for k in adapters)

    # the merged weights in the model without LoRA give the LoRA model's eps
    plain = SDModels.create(
        family="wukong", dtype=torch.float32, device="cpu",
        unet_config=UNetConfig(**unet_kw("wukong", False)),
        vae_config=VAEConfig(**tp.VAE_KW),
        text_config=CLIPTextConfig(use_quick_gelu=True, **tp.CLIP_KW))
    plain.load_state_dict({k: v.numpy() for k, v in merged.items()})
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32)).astype(np.float32))
    t = torch.tensor([10, 500])
    with torch.no_grad():
        np.testing.assert_allclose(plain.unet(x, t, ctx).numpy(), pm.unet(x, t, ctx).numpy(),
                                   atol=1e-4)

    # adapter-only checkpoint: saved through the LoRA transform, reloaded,
    # applied over a fresh LoRA model's state dict
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_every_steps=2, keep_max=2)
    mgr.save(1, optim.lora_checkpoint_transform(full)(full))
    saved = mgr.restore_latest()
    assert set(saved) == set(adapters)
    fresh = {k: (torch.zeros_like(v) if lora.is_lora_name(k) else v) for k, v in full.items()}
    applied = lora.apply_lora_state_dict(fresh, saved)
    assert all(torch.equal(applied[k], full[k]) for k in full)
    assert merge_params(fresh, saved).keys() == full.keys()
    with pytest.raises(KeyError):
        lora.apply_lora_state_dict(fresh, {"model.diffusion_model.x.lora_a": torch.zeros(1)})

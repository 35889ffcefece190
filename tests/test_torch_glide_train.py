"""GLIDE training in the port (train/glide_loss.py, train/resample.py,
train/ema.py, data/glide_dataset.py, the GLIDE AdamW of train/optim.py,
cli/glide_train.py) against the JAX package's, fp32 on the CPU.

The train steps run the JAX CLI's `step_fn` (minddiffusion_tpu/cli/
glide_train.py:117-134) as separate jitted pieces (the loss under
value_and_grad, the optax chain, the EMA): XLA:CPU takes minutes to compile
them as one program. Both packages start from the same weights (every JAX
leaf drawn with numpy, carried across by io/glide_weights) and see the same
batch and the JAX step's own noise, normal(split(key)). The models are the
JAX CLI's --debug_tiny configs at model_channels 64 (at 32 every GroupNorm
group holds one channel, so the conv bias in front of each ResBlock's
second norm has an exact gradient of zero, both packages return rounding
noise there, and AdamW turns noise of any size into steps of about lr);
16 px base, 32 px super-res. Warmup 0, so both steps have a non-zero lr.

Tolerances: normal_kl, the cdf and the discretized log-likelihood 1e-6
relative in float64 (in fp32 a bin's mass is a difference of two cdf
values and carries each package's tanh rounding divided by the mass);
vb_term 1e-6 relative in fp32, on inputs as a model in training gives them;
its gradients, the loss and grad_norm 1e-5 relative (fp32 through chained
ops); params and EMA after the steps within 1% of the steps' size (0.01 *
lr * steps; AdamW moves an element by about lr a step) where every step's
gradient element is 0 or above 1e-3 of its tensor's largest (over 85% of
the elements; not the xf's key biases, whose exact gradient is 0), and
within lr * steps everywhere. AdamW divides each gradient element by its
own magnitude, so an element near zero (a unit at SiLU's stationary point,
say) turns fp32 rounding into a step of any size up to about lr; the exact
optimizer chain is held by the optax test.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from minddiffusion_tpu.core import schedules as jax_sched
from minddiffusion_tpu.data import glide_dataset as jax_data
from minddiffusion_tpu.models import glide as jax_glide
from minddiffusion_tpu.train import ema as jax_ema
from minddiffusion_tpu.train import glide_loss as jax_gl
from minddiffusion_tpu.train import lr_schedules as jax_lr
from minddiffusion_tpu.train import resample as jax_resample
from minddiffusion_tpu_torch.cli import glide_train
from minddiffusion_tpu_torch.core import schedules
from minddiffusion_tpu_torch.data import glide_dataset
from minddiffusion_tpu_torch.io.glide_weights import (
    stage_state_dict, train_checkpoint_from_jax, variables_to_state_dict)
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager
from minddiffusion_tpu_torch.models import glide
from minddiffusion_tpu_torch.pipelines.glide_cascade import GlideModels
from minddiffusion_tpu_torch.train import ema, glide_loss, lr_schedules, optim, resample

import torch_parity as tp

B, BASE, SR, LR, EMA_DECAY = 2, 16, 32, 1e-3, 0.9
XF_KW = dict(width=32, layers=2, heads=4, text_ctx=8, n_vocab=64)
UNET_KW = dict(model_channels=64, num_res_blocks=1, attention_resolutions=(2,),
               channel_mult=(1, 2), num_head_channels=16)


def assert_rel(got, ref, tol, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=tol * np.abs(ref).max(), rtol=0,
                               err_msg=msg)


def t_(x):
    return torch.from_numpy(np.array(x))


def schedule_pair(name="squaredcos_cap_v2", n=1000):
    return (jax_sched.respace_schedule(jax_sched.make_beta_schedule(name, n), set(range(n))),
            schedules.respace_schedule(schedules.make_beta_schedule(n, schedule=name),
                                       set(range(n))))


# ---- the loss pieces ---------------------------------------------------------

def test_kl_cdf_and_discretized_ll_match_jax():
    """In float64 on both sides: in fp32 a bin's mass is a difference of two
    cdf values, so each package's log-likelihood carries its tanh's rounding
    divided by the mass (2e-5 relative at one pixel scale). The fp32 path is
    held through vb_term below."""
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.standard_normal((4, 64)) for _ in range(4))
    z = np.linspace(-6, 6, 301)
    # x on the uint8 grid, both edges included; scales from wide to one bin,
    # the means within three scales of x
    x = (np.arange(256) / 127.5 - 1.0)[None].repeat(3, 0)
    log_scales = np.array([[0.0], [-3.0], [-5.0]]).repeat(256, 1)
    means = x + 3.0 * np.exp(log_scales) * rng.uniform(-1, 1, x.shape)
    with jax.enable_x64(True):
        refs = (jax_gl.normal_kl(a, b, c, d), jax_gl.approx_standard_normal_cdf(z),
                jax_gl.discretized_gaussian_log_likelihood(x, means, log_scales))
    gots = (glide_loss.normal_kl(t_(a), t_(b), t_(c), t_(d)),
            glide_loss.approx_standard_normal_cdf(t_(z)),
            glide_loss.discretized_gaussian_log_likelihood(t_(x), t_(means), t_(log_scales)))
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.float64 and np.asarray(ref).dtype == np.float64
        assert_rel(got.numpy(), ref, 1e-6)


def vb_inputs(schedule, seed, t):
    """x0 on the uint8 grid, x_t = q_sample(x0, t, noise) and a predicted
    eps near the noise, as a model in training gives it."""
    rng = np.random.default_rng(seed)
    x0 = (rng.integers(0, 256, (len(t), 8, 8, 3)) / 127.5 - 1.0).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.asarray(t, np.int32)
    x_t = np.asarray(schedule.q_sample(x0, t, noise))
    eps = (noise + 0.3 * rng.standard_normal(x0.shape)).astype(np.float32)
    v = rng.uniform(-1, 1, x0.shape).astype(np.float32)
    return x0, x_t, t, eps, v


@pytest.mark.parametrize("t", [[0, 0], [1, 500], [0, 999]])
def test_vb_term_matches_jax(t):
    js, ps = schedule_pair()
    x0, x_t, tt, eps, v = vb_inputs(js, 1, t)
    ref = jax_gl.vb_term(js, x0, x_t, tt, eps, v)
    got = glide_loss.vb_term(ps, t_(x0), t_(x_t), t_(tt), t_(eps), t_(v))
    assert_rel(got.numpy(), ref, 1e-6)


def test_vb_gradients_match_jax_and_stop_at_eps():
    js, ps = schedule_pair("linear_plain")
    x0, x_t, tt, eps, v = vb_inputs(js, 2, [0, 250, 999])
    w = np.array([0.5, 1.0, 2.0], np.float32)

    def jloss(eps_, v_):
        mse = jnp.mean((eps_ - x_t) ** 2, axis=(1, 2, 3))
        return jnp.mean(w * (mse + jax_gl.vb_term(js, x0, x_t, tt, eps_, v_)))

    refs = jax.grad(jloss, argnums=(0, 1))(eps, v)
    pe, pv = t_(eps).requires_grad_(True), t_(v).requires_grad_(True)
    mse = torch.mean((pe - t_(x_t)) ** 2, dim=(1, 2, 3))
    loss = torch.mean(t_(w) * (mse + glide_loss.vb_term(ps, t_(x0), t_(x_t), t_(tt), pe, pv)))
    for got, ref in zip(torch.autograd.grad(loss, (pe, pv)), refs):
        assert_rel(got.numpy(), ref, 1e-5)
    # the VLB alone: no gradient reaches eps (the frozen mean), v's does
    pe, pv = t_(eps).requires_grad_(True), t_(v).requires_grad_(True)
    g_eps, g_v = torch.autograd.grad(
        glide_loss.vb_term(ps, t_(x0), t_(x_t), t_(tt), pe, pv).sum(), (pe, pv),
        allow_unused=True)
    assert g_eps is None or not g_eps.any()
    assert g_v.abs().sum() > 0


def test_glide_diffusion_loss_matches_jax():
    js, ps = schedule_pair()
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 10, 999], np.int32)
    w = np.array([1.0, 0.5, 2.0], np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))

    def jmodel(x, t_, tok, mask):
        return jnp.tanh(x) * 0.5, jnp.sin(x)

    def pmodel(x, t_, tok, mask):
        return torch.tanh(x) * 0.5, torch.sin(x)

    ref_loss, ref_m = jax_gl.glide_diffusion_loss(jmodel, js, x0, None, None, t, w, key)
    loss, m = glide_loss.glide_diffusion_loss(pmodel, ps, t_(x0), None, None, t_(t), t_(w),
                                              t_(noise))
    for k in ("loss", "mse", "vlb"):
        np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=1e-6, err_msg=k)


# ---- samplers, EMA, the optimizer --------------------------------------------

def test_samplers_match_jax_bit_for_bit():
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        for x, y in zip(resample.UniformSampler(1000).sample_np(a, 7),
                        jax_resample.UniformSampler(1000).sample_np(b, 7)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    port, ref = resample.LossSecondMomentResampler(12, 3), \
        jax_resample.LossSecondMomentResampler(12, 3)
    a, b, losses = np.random.RandomState(6), np.random.RandomState(6), np.random.default_rng(7)
    for i in range(8):
        tp_, wp = port.sample_np(a, 16)
        tj, wj = ref.sample_np(b, 16)
        assert np.array_equal(tp_, tj) and np.array_equal(wp, wj), i
        ls = losses.uniform(0, 1 + tj % 5, 16)
        port.update(tp_, ls)
        ref.update(tj, ls)
        assert np.array_equal(port.weights_np(), ref.weights_np())
    assert port._warmed_up()
    t, w = resample.UniformSampler(10).sample(torch.Generator().manual_seed(0), 64)
    assert 0 <= int(t.min()) and int(t.max()) < 10 and (w == 1).all()


def test_ema_matches_jax():
    rng = np.random.default_rng(8)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    p1 = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
    e = ema.init_ema({k: t_(v) for k, v in p0.items()})
    ema.update_ema(e, {k: t_(v) for k, v in p1.items()}, 0.99)
    ref = jax_ema.update_ema(jax_ema.init_ema(p0), p1, 0.99)
    for k in p0:
        assert_rel(e[k].numpy(), ref[k], 1e-6, k)


def test_glide_adamw_matches_the_optax_chain():
    """clip_by_global_norm(1.0) + optax.adamw(warmup_then_decay(...)) over
    every param, 4 updates, the first with a norm above the clip."""
    rng = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (5,), "emb": (7, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    sched = jax_lr.warmup_then_decay(LR, LR * 0.01, 2, 10)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    state, jp = tx.init(p), dict(p)
    params = {k: torch.nn.Parameter(t_(v)) for k, v in p.items()}
    opt = optim.AdamW(params, lr_schedules.warmup_then_decay(LR, LR * 0.01, 2, 10),
                      **optim.GLIDE_ADAMW)
    for i in range(4):
        g = {k: (rng.standard_normal(s) * (3.0 if i == 0 else 0.1)).astype(np.float32)
             for k, s in shapes.items()}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step({k: t_(v) for k, v in g.items()})
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
    assert int(opt.count) == 4
    for k in p:
        assert_rel(params[k].detach().numpy(), jp[k], 1e-6, k)


# ---- data --------------------------------------------------------------------

def write_dataset(d, n=9, side=(40, 52)):
    rng = np.random.default_rng(10)
    (d / "imgs").mkdir()
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*side, 3), dtype=np.uint8)).save(
            d / "imgs" / f"g{i}.png")
        rows.append(f"imgs/g{i}.png\t一只 猫 number {i}")
    rows.append("imgs/missing.png\tan unreadable file")
    (d / "m.tsv").write_text("\n".join(rows) + "\n")
    (d / "manifests.txt").write_text(str(d / "m.tsv") + "\n")
    return str(d / "manifests.txt")


def encode(text):
    return glide_train.fallback_tokens(text, XF_KW["text_ctx"])


@pytest.mark.parametrize("super_res", [False, True])
def test_dataset_epochs_match_jax_bit_for_bit(tmp_path, super_res):
    manifest = write_dataset(tmp_path)
    pairs = glide_dataset.read_manifests(manifest)
    assert pairs == jax_data.read_manifests(manifest) and len(pairs) == 10
    kw = dict(batch_size=3, image_size=32, num_timesteps=1000, text_drop_p=0.4, seed=11,
              super_res_size=8 if super_res else None)
    port = list(glide_dataset.GlideTextImageDataset(pairs, encode, **kw).epoch(1))
    ref = list(jax_data.GlideTextImageDataset(pairs, encode, **kw).epoch(1))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert set(a) == set(b) == ({"image", "tokens", "mask", "t", "weights"}
                                    | ({"low_res"} if super_res else set()))
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    dropped = sum(int((bt["mask"] == 0).all(axis=1).sum()) for bt in port)
    assert 0 < dropped < 9


def test_fallback_tokens_are_the_same_in_every_process():
    code = ("from minddiffusion_tpu_torch.cli.glide_train import fallback_tokens;"
            "print(fallback_tokens('一只 猫 a cat', 8)[0].tolist())")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           check=True, env=dict(os.environ, PYTHONHASHSEED=s)).stdout
            for s in ("1", "2")}
    assert len(outs) == 1
    toks, mask = glide_train.fallback_tokens("一只 猫 a cat", 8)
    assert outs.pop().strip() == str(toks.tolist())
    assert mask.tolist() == [1, 1, 1, 1, 0, 0, 0, 0] and toks[4:].tolist() == [50000] * 4


# ---- the train step ----------------------------------------------------------

def jax_init(module, *args, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return tp.randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def jax_step_parts(model, schedule, super_res):
    """The JAX CLI's step_fn, cut into three jitted pieces."""
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jax_lr.warmup_then_decay(LR, LR * 0.01, 0, 100)))

    def loss_fn(params, batch, rng):
        low = (batch["low_res"],) if super_res else ()

        def mfn(x, t, tk, mk):
            return model.apply(params, x, t, *low, tk, mk)

        return jax_gl.glide_diffusion_loss(mfn, schedule, batch["image"], batch["tokens"],
                                           batch["mask"], batch["t"], batch["weights"], rng)

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update(params, opt_state, ema_p, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax_ema.update_ema(ema_p, params, EMA_DECAY)

    def step(params, opt_state, ema_p, batch, rng):
        (_, metrics), grads = grad(params, batch, rng)
        params, opt_state, ema_p = update(params, opt_state, ema_p, grads)
        metrics = dict(jax.device_get(metrics), grad_norm=float(optax.global_norm(grads)))
        return params, opt_state, ema_p, metrics, jax.device_get(grads)

    return tx, step


def train_batch(seed, size, super_res):
    rng = np.random.default_rng(seed)
    out = {"image": (rng.integers(0, 256, (B, size, size, 3)) / 127.5 - 1).astype(np.float32),
           "tokens": rng.integers(0, XF_KW["n_vocab"], (B, XF_KW["text_ctx"])).astype(np.int32),
           "mask": (np.arange(XF_KW["text_ctx"])[None] < np.array([[5], [8]])).astype(np.int32),
           "t": np.array([250, 700], np.int32),
           "weights": np.array([1.0, 0.5], np.float32)}
    if super_res:
        out["low_res"] = rng.uniform(-1, 1, (B, BASE, BASE, 3)).astype(np.float32)
    return out


@pytest.mark.parametrize("super_res,steps", [(False, 2), (True, 1)])
def test_train_steps_match_jax(super_res, steps):
    size = SR if super_res else BASE
    name = "linear_plain" if super_res else "squaredcos_cap_v2"
    js, ps = schedule_pair(name)
    xcfg = jax_glide.XfConfig(**XF_KW)
    ucfg = jax_glide.GlideUNetConfig(in_channels=6 if super_res else 3, **UNET_KW)
    jm = (jax_glide.SuperResText2ImUNet if super_res else jax_glide.Text2ImUNet)(ucfg, xcfg)
    toks = jnp.zeros((1, XF_KW["text_ctx"]), jnp.int32)
    low = (jnp.zeros((1, BASE, BASE, 3)),) if super_res else ()
    params = jax_init(jm, jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32), *low,
                      toks, toks, seed=12)
    pm = (glide.SuperResText2ImUNet if super_res else glide.Text2ImUNet)(
        glide.GlideUNetConfig(in_channels=6 if super_res else 3, **UNET_KW),
        glide.XfConfig(**XF_KW))
    pm.load_state_dict({k: t_(v) for k, v in variables_to_state_dict(params).items()},
                       strict=True)
    state = glide_train.create_train_state(pm, LR, 0, 100)
    pstep = glide_train.build_step(ps, super_res, EMA_DECAY)

    tx, jstep = jax_step_parts(jm, js, super_res)
    jp, jopt, jema = params, tx.init(params), jax_ema.init_ema(params)
    batch = train_batch(13, size, super_res)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(14)
    # elements whose gradient is 0 or above 1e-3 of its tensor's largest in every step
    resolved = None
    for i in range(steps):
        rng, sub = jax.random.split(rng)
        jp, jopt, jema, jmet, jgrads = jstep(jp, jopt, jema, jb, sub)
        big = {n: (np.abs(g) > 1e-3 * np.abs(g).max()) | (g == 0)
               for n, g in variables_to_state_dict(jgrads).items()}
        resolved = big if resolved is None else {n: resolved[n] & big[n] for n in big}
        noise = np.asarray(jax.random.normal(sub, batch["image"].shape, jnp.float32))
        pmet = pstep(state, {k: t_(v) for k, v in batch.items()}, 0, noise=t_(noise))
        for k in ("loss", "mse", "vlb", "grad_norm"):
            np.testing.assert_allclose(pmet[k].item(), float(jmet[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    assert state.step == steps and int(state.optimizer.count) == steps
    for n, m in resolved.items():
        # the xf's key biases: its softmax is shift-invariant along a row, so
        # their exact gradient is 0 and both packages return rounding noise
        if n.startswith("xf.block_") and n.endswith(".qkv.bias"):
            m[XF_KW["width"]:2 * XF_KW["width"]] = False
    got = dict(pm.state_dict())
    before = variables_to_state_dict(params)
    n_resolved = sum(int(m.sum()) for m in resolved.values())
    assert n_resolved > 0.85 * sum(m.size for m in resolved.values())
    for tree, ref in (("params", variables_to_state_dict(jax.device_get(jp))),
                      ("ema", variables_to_state_dict(jax.device_get(jema)))):
        port = got if tree == "params" else state.ema
        assert set(port) == set(ref)
        for n, r in ref.items():
            p = port[n].detach().numpy()
            np.testing.assert_allclose(p[resolved[n]], r[resolved[n]],
                                       atol=1e-2 * LR * steps, rtol=0, err_msg=f"{tree} {n}")
            np.testing.assert_allclose(p, r, atol=LR * steps, rtol=0, err_msg=f"{tree} {n}")
            assert not np.array_equal(r, before[n]), f"{tree} {n} did not move"


# ---- the CLI -----------------------------------------------------------------

def test_glide_train_cli_base_and_super_res(tmp_path, capsys):
    manifest = write_dataset(tmp_path, n=4, side=(36, 40))
    common = ["--image_caption_path_file", manifest, "--debug_tiny", "--device", "cpu",
              "--dtype", "fp32", "--image_size", "16", "--train_batch_size", "2",
              "--warmup_steps", "0", "--lr", "1e-4", "--save_checkpoint_steps", "2"]
    base = glide_train.main(common + ["--output_path", str(tmp_path / "base"),
                                      "--max_steps", "2"])
    sr = glide_train.main(common + ["--output_path", str(tmp_path / "sr"), "--super_res",
                                    "--super_res_image_size", "32", "--max_steps", "1"])
    assert base.step == 2 and sr.step == 1
    assert isinstance(sr.models, glide.SuperResText2ImUNet)
    assert "loss" in capsys.readouterr().out
    ckpt = CheckpointManager(str(tmp_path / "base" / "ckpt"))
    assert ckpt.steps() == [1, 2]
    saved = ckpt.restore_latest()
    assert set(saved) == {"params", "ema"}
    for tree, ref in (("params", base.models.state_dict()), ("ema", base.ema)):
        assert set(saved[tree]) == set(ref)
        assert all(torch.equal(saved[tree][k], ref[k].detach()) for k in ref), tree
    # either tree loads strictly into the cascade's base (bf16)
    ucfg, xcfg = glide_train.model_configs(False, True)
    models = GlideModels.create(dtype=torch.float32, device="cpu", with_srgan=False,
                                base_unet=ucfg, sr_unet=glide_train.model_configs(True, True)[0],
                                xf=xcfg)
    models.load_state_dict({**models.state_dict(),
                           **stage_state_dict(saved["ema"], "base")})
    assert torch.equal(models.base.unet.out_conv.weight, saved["ema"]["unet.out_conv.weight"])
    # a JAX checkpoint {"params", "ema"} comes across with the same names
    jax_ckpt = {"params": {"params": {"time_embed_0": {"kernel": np.ones((2, 3), np.float32)}}},
                "ema": {"params": {"time_embed_0": {"kernel": np.zeros((2, 3), np.float32)}}}}
    carried = train_checkpoint_from_jax(jax_ckpt)
    assert carried["params"]["time_embed_0.weight"].shape == (3, 2)


def test_glide_train_cli_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        glide_train.main(["--image_caption_path_file", str(tmp_path / "m.txt")])


def test_uniform_sampler_draws_on_the_generators_device():
    """`UniformSampler.sample` takes its device from the generator (a CUDA
    generator draws on the card), or from an explicit `device`; with
    neither it raises instead of falling back to the CPU."""
    sampler = resample.UniformSampler(10)
    t, w = sampler.sample(torch.Generator().manual_seed(0), 8)
    assert t.device == w.device == torch.device("cpu")
    t, w = sampler.sample(None, 8, device="meta")
    assert t.device.type == w.device.type == "meta" and t.shape == (8,)
    with pytest.raises(ValueError, match="generator or a device"):
        sampler.sample(None, 8)

"""The port's process grid against the JAX package's mesh, on the CPU:
minddiffusion_tpu_torch/parallel/ (MeshConfig, the param rule, tp_report,
assert_tp_effective, the batch split), the datasets' node shards and rank
rows, the SD and GLIDE train steps under dp and fsdp, the gathered
checkpoints, the batch-split txt2img and the two train CLIs on a grid.

The rules are pure functions, held here against minddiffusion_tpu/parallel/
mesh.py on the tiny SD model of tests/test_train_parallel.py and the tiny
GLIDE model of its GLIDE case: every param's JAX spec, carried to the
port's name (io/sd_weights and io/glide_weights translators) and torch
layout (a Dense kernel transposed, a conv kernel HWIO -> OIHW), equals the
port's spec of that name and shape.

The tp pieces (parallel/mesh.tp_shard) are pure functions too: on the
tiny SD UNet with LoRA, CLIP and GLIDE models at tp 2 and 4 every piece has
the rule's size, a packed projection's piece is block r of each part, and
tp_unshard joins the pieces back; shard_params places them (on a stand-in
mesh, no process group) and refuses a LoRA rank that tp does not divide.

The multi-rank cases run in one session of two spawned processes in a gloo
group and one of four (tests/torch_dist.py: a FileStore rendezvous, one
thread a rank, a deadline that fails instead of hanging), which the JAX
references run beside. The SD step at dp 2, fsdp 2, tp 2 and fsdp 2 x tp 2
(grids (dp, fsdp, tp)) takes test_torch_train.py's 3 finetune steps on a
tiny SD2 (model channels 48, 16 channels a head: 3 heads at ds1, which tp
2 does not divide, 6 at ds2; warmup 1), from latents, with the JAX step's
own draws for the global batch, and is held against the JAX step's jitted
pieces at that file's tolerances (loss and grad_norm 1e-5 relative, params
1e-3 * lr * steps); its checkpoints, gathered whole by rank 0, against the
one-process port's. The GLIDE step at dp 2 and at tp 2 (a tiny UNet with 3
heads at ds1 and 6 at ds2) and a LoRA step at tp 2 are held against the
port's one-process steps: the metrics within 1e-5 relative, the params
within 1e-3 * lr where the one-process gradient is resolved
(test_torch_glide_train.py's rule: zero, or above 1e-3 of its tensor's
largest), and within one AdamW step elsewhere (rounding noise on a
gradient that is 0 in exact arithmetic moves a param by up to lr). Under tp
every param whole on both tp ranks has the same gradient on each, bitwise.
txt2img over 2 ranks and over dp 2 x tp 2 is bytewise the one-process call
and within 1 uint8 of the JAX single-device `build_txt2img` on the same
explicit x_T.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_glide_train as tg
import test_torch_train as tt
import torch_dist as td
import torch_parity as tp
from minddiffusion_tpu.data.dataset import TextImageDataset as JaxTextImageDataset
from minddiffusion_tpu.data.dataset_db import DreamBoothDataset as JaxDreamBoothDataset
from minddiffusion_tpu.data.glide_dataset import GlideTextImageDataset as JaxGlideDataset
from minddiffusion_tpu.models import glide as jax_glide
from minddiffusion_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from minddiffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from minddiffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from minddiffusion_tpu.parallel import mesh as jax_mesh
from minddiffusion_tpu.pipelines.stable_diffusion import SDModels as JaxSDModels
from minddiffusion_tpu.pipelines.stable_diffusion import StableDiffusionPipeline as JaxPipe
from minddiffusion_tpu.train import trainer as jax_trainer
from minddiffusion_tpu_torch.cli import common, glide_train
from minddiffusion_tpu_torch.data import DreamBoothDataset, TextImageDataset
from minddiffusion_tpu_torch.data.glide_dataset import GlideTextImageDataset
from minddiffusion_tpu_torch.io import glide_weights, sd_weights
from minddiffusion_tpu_torch.io.checkpoints import CheckpointManager, load_checkpoint
from minddiffusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from minddiffusion_tpu_torch.models.glide import GlideUNetConfig, Text2ImUNet, XfConfig
from minddiffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from minddiffusion_tpu_torch.models.vae import VAEConfig
from minddiffusion_tpu_torch.parallel import mesh as port_mesh
from minddiffusion_tpu_torch.parallel.collectives import gradients
from minddiffusion_tpu_torch.parallel.mesh import MeshConfig, Rows
from minddiffusion_tpu_torch.pipelines.stable_diffusion import SDModels

from test_torch_train_data import write_images

LR, STEPS = tt.LR, tt.STEPS
# the JAX tiny models of tests/test_train_parallel.py (tiny_setup and the GLIDE case)
SD_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4, context_dim=32)
SD_TEXT = dict(vocab_size=64, width=32, layers=1, heads=4, context_length=8)
GLIDE_UNET = dict(in_channels=3, model_channels=32, out_channels=6, num_res_blocks=1,
                  attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=16)
GLIDE_XF = dict(width=32, layers=1, heads=2, text_ctx=8, n_vocab=64)
MESHES = [(4, 2, 1), (2, 2, 2), (1, 1, 2)]
# the grid steps' tiny SD2 UNet (test_torch_train.py's at model channels 48,
# 16 channels a head): 3 heads at ds1, which tp 2 does not divide (every
# head on every tp rank), 6 at ds2 (3 a tp rank)
SD_GRID_UNET = dict(tt.unet_kw("sd2", False), model_channels=48, num_head_channels=16)
# the grid GLIDE steps' UNet: 3 heads at ds1 (C 48), 6 at ds2 and the middle
GLIDE_GRID_UNET = dict(in_channels=3, model_channels=48, num_res_blocks=1,
                       attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread (the tier-1 run has six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- MeshConfig ---------------------------------------------------------------

@pytest.mark.parametrize("n,dp,fsdp,tp_", [
    (8, -1, 2, 1), (8, -1, 2, 2), (4, 2, 2, 1), (2, 2, 1, 1), (1, -1, 1, 1),
    (8, 3, 1, 1), (6, -1, 4, 1), (1, 2, 1, 1), (2, 1, 2, 2)])
def test_mesh_config_resolves_as_jax(n, dp, fsdp, tp_):
    try:
        ref = jax_mesh.MeshConfig(dp, fsdp, tp_).resolve(n)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=str(e)):
            MeshConfig(dp, fsdp, tp_).resolve(n)
        return
    got = MeshConfig(dp, fsdp, tp_).resolve(n)
    assert (got.dp, got.fsdp, got.tp) == (ref.dp, ref.fsdp, ref.tp)


# ---- the param rule -----------------------------------------------------------

def _jax_mesh(shape):
    n = int(np.prod(shape))
    return jax_mesh.make_mesh(jax_mesh.MeshConfig(*shape), devices=jax.devices()[:n])


def _sd_trees():
    """(JAX param shapes, {JAX path: (port name, layout)}, port {name: meta param})."""
    jm = JaxSDModels.create(family="wukong", dtype=jnp.float32,
                            unet_config=JaxUNetConfig(**SD_UNET),
                            text_config=JaxCLIPConfig(**SD_TEXT))
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: {
        "unet": jm.unet.init(rng, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 8, 32))),
        "text": jm.text_encoder.init(rng, jnp.zeros((1, 8), jnp.int32))})
    translate = {"unet": sd_weights.unet_translator(jm.unet.config),
                 "text": sd_weights.clip_translator}
    names = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [str(k.key) for k in path]
        name, layout = translate[keys[0]](tuple(keys[2:]))
        names[jax_mesh._path_str(path)] = (sd_weights.PREFIXES[keys[0]] + name, layout)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig(use_linear_in_transformer=False, **SD_UNET))
        text = CLIPTextEncoder(CLIPTextConfig(**SD_TEXT))
    port = {sd_weights.PREFIXES[k] + n: p for k, m in (("unet", unet), ("text", text))
            for n, p in m.named_parameters()}
    return shapes, names, port


def _glide_trees():
    jm = jax_glide.Text2ImUNet(jax_glide.GlideUNetConfig(**GLIDE_UNET),
                               jax_glide.XfConfig(**GLIDE_XF))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32)))
    names = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = tuple(str(k.key) for k in path)
        name, _ = glide_weights._port_leaf(keys[1:], np.zeros(leaf.shape, np.float32))
        layout = ("ident" if keys[-1] != "kernel" else
                  "dense" if len(leaf.shape) == 2 else "conv")
        names[jax_mesh._path_str(path)] = (name, layout)
    with torch.device("meta"):
        port = dict(Text2ImUNet(GlideUNetConfig(**GLIDE_UNET),
                                XfConfig(**GLIDE_XF)).named_parameters())
    return shapes, names, port


TREES = {"sd": _sd_trees, "glide": _glide_trees}
TORCH_FROM_FLAX = {"dense": (1, 0), "conv": (3, 2, 0, 1)}   # torch dim j = flax dim perm[j]


@pytest.fixture(scope="module", params=list(TREES))
def trees(request):
    return request.param, TREES[request.param]()


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_param_rule_matches_jax(trees, shape):
    _, (shapes, names, port) = trees
    jmesh = _jax_mesh(shape)
    sizes = dict(zip(("dp", "fsdp", "tp"), shape))
    assert {n for n, _ in names.values()} == set(port)      # every port param, once
    sharded = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        pstr = jax_mesh._path_str(path)
        name, layout = names[pstr]
        jspec = tuple(jax_mesh._param_spec(pstr, leaf, jmesh))
        jspec = jspec + (None,) * (len(leaf.shape) - len(jspec))
        perm = TORCH_FROM_FLAX.get(layout, tuple(range(len(jspec))))
        want = tuple(jspec[perm[j]] for j in range(len(jspec)))
        got = port_mesh.param_spec(name, tuple(port[name].shape), sizes)
        assert got == want, (pstr, name, got, want)
        sharded += any(want)
    assert sharded > 0


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_tp_report_matches_jax(trees, shape):
    _, (shapes, names, port) = trees
    ref = jax_mesh.tp_report(shapes, _jax_mesh(shape))
    got = port_mesh.tp_report(port, dict(zip(("dp", "fsdp", "tp"), shape)))
    for k in ("tp_params", "tp_bytes", "total_2d_bytes"):
        assert got[k] == ref[k], k
    assert got["bytes_fraction"] == pytest.approx(ref["bytes_fraction"], rel=1e-12)
    assert set(got["names"]) == {names[n][0] for n in ref["names"]}
    if shape[2] > 1:
        rep = port_mesh.assert_tp_effective(port, dict(tp=shape[2]))
        assert rep["tp_params"] == ref["tp_params"] > 0
        assert jax_mesh.assert_tp_effective(shapes, _jax_mesh(shape)) is not None


def test_tp_with_renamed_modules_raises(trees):
    kind, (shapes, _, port) = trees

    def rename(n):
        for a, b in (("to_", "x_"), ("qkv", "fused"), ("in_proj", "fused"), ("mlp", "ffn"),
                     ("out_proj", "o"), ("ff.net", "gated_ff.net"), ("encoder_kv", "ekv")):
            n = n.replace(a, b)
        return n

    broken = {rename(n): p for n, p in port.items()}
    with pytest.raises(ValueError, match="TP rules"):
        port_mesh.assert_tp_effective(broken, {"dp": 1, "fsdp": 1, "tp": 2})
    assert port_mesh.assert_tp_effective(broken, {"dp": 1, "fsdp": 2, "tp": 1}) is None


# ---- tp pieces ----------------------------------------------------------------

def _tp_models():
    """{kind: {name: meta param}} of the tiny SD UNet with LoRA, CLIP and
    GLIDE models."""
    with torch.device("meta"):
        return {"sd_lora": dict(UNetModel(UNetConfig(
                    use_linear_in_transformer=True, enable_lora=True, **SD_UNET))
                    .named_parameters()),
                "clip": dict(CLIPTextEncoder(CLIPTextConfig(**SD_TEXT)).named_parameters()),
                "glide": dict(Text2ImUNet(GlideUNetConfig(**GLIDE_UNET),
                                          XfConfig(**GLIDE_XF)).named_parameters())}


PACKED = {"ff.net.0.proj.weight": 2, "in_proj_weight": 3, "qkv.weight": 3,
          "encoder_kv.weight": 2}


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("kind", ["sd_lora", "clip", "glide"])
def test_tp_shard_round_trips(kind, tp_size):
    """Every param: the pieces have the rule's size (1/tp on its tp dim,
    whole elsewhere), a packed projection's piece r is block r of each
    part, and tp_unshard joins the pieces back into the tensor."""
    gen = torch.Generator().manual_seed(tp_size)
    params = _tp_models()[kind]
    seen = set()
    for name, p in params.items():
        x = torch.randn(p.shape, generator=gen)
        spec = port_mesh.param_spec(name, tuple(p.shape), {"tp": tp_size})
        pieces = [port_mesh.tp_shard(name, x, i, tp_size) for i in range(tp_size)]
        if "tp" not in spec:
            assert all(q is x for q in pieces), name
            continue
        d = spec.index("tp")
        want = tuple(n // tp_size if i == d else n for i, n in enumerate(p.shape))
        assert all(tuple(q.shape) == want for q in pieces), (name, want)
        parts = next((n for frag, n in PACKED.items() if name.endswith(frag)), 1)
        assert port_mesh.tp_parts(name) == parts, name
        seen.add(parts)
        for i, q in enumerate(pieces):
            blocks = [part.chunk(tp_size, d)[i] for part in x.chunk(parts, d)]
            assert torch.equal(q, torch.cat(blocks, d)), (name, i)
        assert torch.equal(port_mesh.tp_unshard(name, pieces), x), name
    assert seen == {"sd_lora": {1, 2}, "clip": {1, 3}, "glide": {1, 2, 3}}[kind]


class _StandInMesh:
    """The DeviceMesh calls shard_params makes, for one rank of a (1, 1, tp)
    grid without a process group."""

    mesh_dim_names = port_mesh.AXES

    def __init__(self, tp: int, index: int):
        self.shape, self.index = (1, 1, tp), index

    def get_local_rank(self, axis):
        return self.index

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("index", [0, 1])
def test_shard_params_places_the_tp_pieces(index):
    """Each rank holds its piece of exactly the params whose param_spec
    holds "tp" and every other param whole; each module with a `tp`
    attribute gets the record; tp_report reads the whole shapes."""
    gen = torch.Generator().manual_seed(0)
    unet = UNetModel(UNetConfig(use_linear_in_transformer=True, enable_lora=True, **SD_UNET))
    text = CLIPTextEncoder(CLIPTextConfig(**SD_TEXT))
    for p in [*unet.parameters(), *text.parameters()]:
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    whole = {f"{k}.{n}": p.detach().clone() for k, m in (("unet", unet), ("text", text))
             for n, p in m.named_parameters()}
    rep = port_mesh.tp_report(whole, {"tp": 2})
    tp = port_mesh.shard_params({"unet": unet, "text": text}, _StandInMesh(2, index))
    assert tp.index == index and tp.size == 2 and set(tp.pieces) == set(rep["names"])
    for k, m in (("unet", unet), ("text", text)):
        for n, p in m.named_parameters():
            ref = whole[f"{k}.{n}"]
            assert torch.equal(p.detach(), port_mesh.tp_shard(f"{k}.{n}", ref, index, 2)), n
            assert (p.shape != ref.shape) == (f"{k}.{n}" in tp.pieces), n
    holders = [m for m in [*unet.modules(), *text.modules()] if hasattr(type(m), "tp")]
    assert holders and all(m.tp is tp for m in holders)
    assert port_mesh.shard_params({"unet": UNetModel(UNetConfig(**SD_UNET))},
                                  _StandInMesh(1, 0)) is None


def test_tp_refuses_a_lora_rank_it_does_not_divide():
    unet = UNetModel(UNetConfig(use_linear_in_transformer=True, enable_lora=True,
                                lora_rank=3, **SD_UNET))
    with pytest.raises(NotImplementedError, match="LoRA adapter must be split"):
        port_mesh.shard_params({"unet": unet}, _StandInMesh(2, 0))


# ---- data: node shards and rank rows ------------------------------------------

def tokenize(texts):
    return np.asarray([[len(t), 1, 2] for t in texts], np.int32)


def encode(text):
    return np.asarray([len(text), 3], np.int32), np.asarray([1, 0], np.int32)


def test_dataset_shards_match_jax():
    images = [f"/nowhere/{i}.png" for i in range(11)]
    captions = [f"c{i}" for i in range(11)]
    pairs = list(zip(images, captions))
    for count in (1, 2, 3):
        for index in range(count):
            ref = JaxTextImageDataset(images, captions, tokenize, 2, shard_index=index,
                                      shard_count=count)
            got = TextImageDataset(images, captions, tokenize, 2, shard_index=index,
                                   shard_count=count, row_index=0, row_count=1)
            assert got.images == ref.images and got.captions == ref.captions
            gref = JaxGlideDataset(pairs, encode, 2, shard_index=index, shard_count=count)
            gport = GlideTextImageDataset(pairs, encode, 2, shard_index=index,
                                          shard_count=count, row_index=0, row_count=1)
            assert gport.pairs == gref.pairs
    # one process, no group: node 0 of 1, the whole batch
    assert TextImageDataset(images, captions, tokenize, 2).images == images
    assert port_mesh.data_layout() == (0, 1, 0, 1)


def _joined(make, count, epoch=0):
    """Each rank's batches of `make(row_index, row_count)`, joined by rows."""
    streams = [list(make(r, count).epoch(epoch)) for r in range(count)]
    return [{k: np.concatenate([s[i][k] for s in streams]) for k in streams[0][i]}
            for i in range(len(streams[0]))]


def test_rank_rows_join_to_the_jax_node_batches(tmp_path):
    d = str(tmp_path / "im")
    write_images(d, 6, 3, size=(20, 18))
    images = [os.path.join(d, f"im_{i}.png") for i in range(6)]
    captions = [f"a cat {i}" for i in range(6)]
    kw = dict(image_size=16, random_crop=True, seed=5)
    ref = list(JaxTextImageDataset(images, captions, tokenize, 4, shard_index=0,
                                   shard_count=1, **kw).epoch(1))
    got = _joined(lambda r, n: TextImageDataset(images, captions, tokenize, 4, shard_index=0,
                                                shard_count=1, row_index=r, row_count=n,
                                                **kw), 2, epoch=1)
    assert len(got) == len(ref) == 1
    for k in ("image", "tokens"):
        assert np.array_equal(got[0][k], ref[0][k]), k

    pairs = list(zip(images, captions))
    gref = list(JaxGlideDataset(pairs, encode, 2, image_size=16, seed=5).epoch(0))
    gport = _joined(lambda r, n: GlideTextImageDataset(
        pairs, encode, 2, image_size=16, seed=5, row_index=r, row_count=n), 2)
    assert len(gport) == len(gref) == 3
    for a, b in zip(gport, gref):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)

    cls = str(tmp_path / "cls")
    write_images(cls, 2, 4, size=(20, 18))
    dkw = dict(batch_size=2, image_size=16, train_data_repeats=2, seed=5)
    dref = list(JaxDreamBoothDataset(d, cls, "sks", "cat", tokenize, **dkw).epoch(0))
    dport = _joined(lambda r, n: DreamBoothDataset(d, cls, "sks", "cat", tokenize,
                                                   row_index=r, row_count=n, **dkw), 2)
    assert len(dport) == len(dref) == 6
    for a, b in zip(dport, dref):
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_a_batch_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="does not divide over the node's 2 ranks"):
        TextImageDataset(["a"], ["b"], tokenize, 3, row_index=0, row_count=2)
    with pytest.raises(ValueError, match="does not divide over the node's 2 ranks"):
        GlideTextImageDataset([("a", "b")], encode, 3, row_index=1, row_count=2)
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        Rows(0, 2).take(torch.zeros(3, 1))
    assert torch.equal(Rows(1, 2).take(torch.arange(4)), torch.tensor([2, 3]))
    with pytest.raises(SystemExit, match="mesh 2x1x1 != 1 devices"):
        glide_train.main(["--image_caption_path_file", "m.txt", "--device", "cpu",
                          "--dp", "2"])


# ---- the grid: two ranks --------------------------------------------------------

def _sd_build(ukw: dict):
    """test_torch_train.build's SD2 pair (JAX models, seeded params, the port's
    fp32 models carrying them) at the UNet config `ukw`."""
    jm = JaxSDModels.create(
        family="sd2", dtype=jnp.float32, unet_config=JaxUNetConfig(**ukw),
        vae_config=JaxVAEConfig(**tp.VAE_KW),
        text_config=JaxCLIPConfig(use_quick_gelu=False, **tp.CLIP_KW))
    params = tp.jax_params(jm, 0, size=tt.SIZE)
    pm = SDModels.create(
        family="sd2", dtype=torch.float32, device="cpu", param_dtype=torch.float32,
        unet_config=UNetConfig(**ukw), vae_config=VAEConfig(**tp.VAE_KW),
        text_config=CLIPTextConfig(use_quick_gelu=False, **tp.CLIP_KW))
    pm.load_state_dict(sd_weights.state_dict_from_jax(params, jm.unet.config))
    return jm, params, pm


def _sd_setup(tmp):
    """tests/test_torch_train.py's finetune case (SD2-tiny at SD_GRID_UNET,
    CFG dropout 0.5, warmup 1) on pre-encoded latents (the VAE is frozen;
    without it in the graph XLA compiles the JAX step in a fraction of the
    time) as files for the ranks, and the JAX step; the LoRA config and
    weights (random lora_b) of the LoRA step."""
    jm, params, pm = _sd_build(SD_GRID_UNET)
    jcfg, pcfg = tt.configs("unet", 0.5)
    rng = np.random.default_rng(1)
    b = {"latent": rng.standard_normal((tt.BATCH, tt.SIZE // 8, tt.SIZE // 8, 4)).astype(
            np.float32) * 0.5,
         "tokens": rng.integers(0, 21128, (tt.BATCH, 77)).astype(np.int32)}
    rng = jax.random.PRNGKey(0)
    draws = [tt.jax_draws(rng, i, 0.5, False) for i in range(STEPS)]
    weights = {k: v.clone() for k, v in pm.state_dict().items()}
    torch.save(weights, f"{tmp}/sd_w.pt")
    torch.save({"batch": {k: torch.from_numpy(v) for k, v in b.items()}, "draws": draws},
               f"{tmp}/sd_d.pt")
    nan = [dict(draws[0], noise=torch.full_like(draws[0]["noise"], float("nan")))]
    torch.save({"batch": {k: torch.from_numpy(v) for k, v in b.items()}, "draws": nan},
               f"{tmp}/sd_nan.pt")
    cfg = dict(family="sd2", unet=SD_GRID_UNET, vae=tp.VAE_KW,
               text=dict(tp.CLIP_KW, use_quick_gelu=False), param_dtype=torch.float32,
               train={f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__})
    lora_cfg = dict(cfg, unet=dict(SD_GRID_UNET, enable_lora=True),
                    train=dict(cfg["train"], trainable="lora", cond_dropout=0.0))
    with torch.device("meta"):
        adapters = {sd_weights.PREFIXES["unet"] + n: p for n, p in UNetModel(
            UNetConfig(**lora_cfg["unet"])).named_parameters() if "lora_" in n}
    gen = torch.Generator().manual_seed(4)
    torch.save(dict(weights, **{n: torch.randn(p.shape, generator=gen) * 0.1
                                for n, p in adapters.items()}), f"{tmp}/lora_w.pt")

    def jax_reference():
        jstate = jax_trainer.create_train_state(jm, params, jcfg)
        jstep = tt.jax_step_parts(jm, jcfg, False)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jmetrics = []
        for _ in range(STEPS):
            jstate, m = jstep(jstate, jb, rng)
            jmetrics.append(m)
        jparams = jax.tree.map(np.asarray, jax.device_get(jstate.params))
        return jmetrics, sd_weights.state_dict_from_jax(jparams, jm.unet.config)

    return cfg, lora_cfg, jax_reference


def _glide_setup(tmp):
    model = glide_train.build_model(False, GlideUNetConfig(**GLIDE_GRID_UNET),
                                    XfConfig(**tg.XF_KW), torch.device("cpu"),
                                    torch.float32, 21)
    torch.save(dict(model.state_dict()), f"{tmp}/g_w.pt")
    b = tg.train_batch(13, tg.BASE, False)
    noise = torch.from_numpy(np.random.default_rng(22).standard_normal(
        b["image"].shape).astype(np.float32))
    torch.save({"batch": {k: torch.from_numpy(v) for k, v in b.items()}, "noise": noise},
               f"{tmp}/g_d.pt")
    return dict(super_res=False, unet=GLIDE_GRID_UNET, xf=tg.XF_KW, lr=LR)


def _txt2img_setup(tmp):
    jm = tp.jax_models(attn_impl="fast")
    params = tp.jax_params(jm, seed=3, size=64)
    sd = {k: torch.from_numpy(v) for k, v in
          sd_weights.state_dict_from_jax(params, jm.unet.config).items()}
    torch.save(sd, f"{tmp}/t_w.pt")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 1000, (2, 77)).astype(np.int32)
    uncond = np.zeros((2, 77), np.int32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    torch.save({"tokens": torch.from_numpy(tokens), "uncond": torch.from_numpy(uncond),
                "noise": torch.from_numpy(noise)}, f"{tmp}/t_d.pt")
    run = dict(height=64, width=64, num_steps=2, sampler="ddim", guidance_scale=9.0,
               batch_size=2)
    cfg = dict(family="sd2", unet=dict(tp.UNET_KW, **tp.FAMILY_UNET_KW["sd2"], attn_impl="fast"),
               vae=tp.VAE_KW, text=dict(tp.CLIP_KW, use_quick_gelu=False), txt2img=run)

    def jax_reference():
        return np.asarray(JaxPipe(jm).build_txt2img(64, 64, 2, "ddim", 9.0, 2)(
            params, jnp.asarray(tokens), jnp.asarray(uncond), jax.random.PRNGKey(0),
            noise=jnp.asarray(noise)))

    return cfg, jax_reference


def _cli_setup(tmp):
    assets = os.path.join(tmp, "assets")
    os.makedirs(assets)
    with open(os.path.join(assets, "vocab_zh.txt"), "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat"]) + "\n")
    data = os.path.join(tmp, "data")
    write_images(data, 4, 5)
    with open(os.path.join(data, "m.csv"), "w") as f:
        f.write("dir,text\n" + "".join(f"im_{i}.png,a cat\n" for i in range(4)))
    sd_argv = ["--debug_tiny", "--device", "cpu", "--dtype", "fp32", "--image_size", "64",
               "--image_filter_size", "32", "--train_batch_size", "2", "--max_steps", "2",
               "--warmup_steps", "0", "--start_learning_rate", "1e-3", "--data_path", data,
               "--output_path", os.path.join(tmp, "sd_cli"), "--fsdp", "2"]
    manifest = tg.write_dataset(Path(tmp), n=4, side=(36, 40))
    glide_argv = ["--image_caption_path_file", manifest, "--debug_tiny", "--device", "cpu",
                  "--dtype", "fp32", "--image_size", "16", "--train_batch_size", "2",
                  "--warmup_steps", "0", "--lr", "1e-4", "--save_checkpoint_steps", "2",
                  "--max_steps", "2", "--output_path", os.path.join(tmp, "glide_cli"),
                  "--dp", "2"]
    return assets, sd_argv, glide_argv


TWO_RANKS = ("dp", "fsdp", "nan", "glide", "txt2img", "sd_cli", "glide_cli", "replicated",
             "tp", "tp_nan", "glide_tp", "lora_tp", "txt2img_adaptive")
FOUR_RANKS = ("fsdp_tp", "txt2img_tp")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Every two-rank job in one session and every four-rank job in
    another, both started first; while they run, what each is held
    against: the JAX references (the SD step's compile on a thread of its
    own) and the one-process port runs."""
    tmp = str(tmp_path_factory.mktemp("grid"))
    sd_cfg, lora_cfg, sd_jax = _sd_setup(tmp)
    with ThreadPoolExecutor(1) as pool:
        jax_sd = pool.submit(sd_jax)
        g_cfg = _glide_setup(tmp)
        t_cfg, t_jax = _txt2img_setup(tmp)
        a_cfg = dict(t_cfg, txt2img=dict(t_cfg["txt2img"], sampler="dpm_adaptive"),
                     count_calls=True)
        assets, sd_argv, glide_argv = _cli_setup(tmp)
        sd = (f"{tmp}/sd_w.pt", f"{tmp}/sd_d.pt")
        lora = (f"{tmp}/lora_w.pt", f"{tmp}/sd_d.pt")
        glide = (f"{tmp}/g_w.pt", f"{tmp}/g_d.pt")
        t2i = (f"{tmp}/t_w.pt", f"{tmp}/t_d.pt")
        jobs = [(td.sd_train, (sd_cfg, *sd, (2, 1, 1), f"{tmp}/ck_dp")),
                (td.sd_train, (sd_cfg, *sd, (1, 2, 1), f"{tmp}/ck_fsdp")),
            (td.sd_train, (sd_cfg, sd[0], f"{tmp}/sd_nan.pt", (1, 2, 1), f"{tmp}/ck_nan")),
                (td.glide_train, (g_cfg, *glide, (2, 1, 1))),
                (td.txt2img, (t_cfg, *t2i, (2, 1, 1))),
                (td.run_cli, ("minddiffusion_tpu_torch.cli.train", sd_argv, assets)),
                (td.run_cli, ("minddiffusion_tpu_torch.cli.glide_train", glide_argv)),
                (td.replicated, ()),
                (td.sd_train, (sd_cfg, *sd, (1, 1, 2), f"{tmp}/ck_tp")),
            (td.sd_train, (sd_cfg, sd[0], f"{tmp}/sd_nan.pt", (1, 1, 2), f"{tmp}/ck_tp_nan")),
                (td.glide_train, (g_cfg, *glide, (1, 1, 2))),
                (td.sd_train, (lora_cfg, *lora, (1, 1, 2), f"{tmp}/ck_lora_tp")),
                (td.txt2img, (a_cfg, *t2i, (2, 1, 1)))]
        session = td.start_ranks(jobs, 2, tmp, timeout=400)
        four = td.start_ranks([(td.sd_train, (sd_cfg, *sd, (1, 2, 2), f"{tmp}/ck_fsdp_tp")),
                               (td.txt2img, (t_cfg, *t2i, (2, 1, 2)))], 4, tmp, timeout=400)
        out = dict(
            tmp=tmp, t_jax=t_jax(),
            one=td.sd_train(sd_cfg, *sd, None, f"{tmp}/ck_one"),
            lora_one=td.sd_train(lora_cfg, *lora, None, f"{tmp}/ck_lora_one"),
            glide_one=td.glide_train(g_cfg, *glide, None),
            txt2img_one=td.txt2img(t_cfg, *t2i, None),
            txt2img_adaptive_one=td.txt2img(a_cfg, *t2i, None))
        out["jmetrics"], out["jparams"] = jax_sd.result()
    for names, ranks in ((TWO_RANKS, session.join()), (FOUR_RANKS, four.join())):
        out.update({k: [r[i] for r in ranks] for i, k in enumerate(names)})
    return out


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp", "fsdp_tp"])
def test_sd_step_on_the_grid_matches_jax(grid, mode):
    ranks = grid[mode]
    assert all(r["ckpt"] is None for r in ranks[1:])
    assert ranks[0]["saved"] == list(range(1, STEPS + 1))
    for r in ranks:
        assert len(r["metrics"]) == STEPS
        for got, ref in zip(r["metrics"], grid["jmetrics"]):
            for k in ("loss", "grad_norm", "mse_t_mean"):
                np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-5, err_msg=k)
            assert got["grads_finite"] == 1.0
    ckpt = ranks[0]["ckpt"]
    assert set(ckpt) == set(grid["jparams"])
    _hold_params(ckpt, {k: torch.from_numpy(v) for k, v in grid["jparams"].items()},
                 grid["one"]["resolved"])


def _hold_params(got, ref, resolved):
    """The params after the steps: within 1e-3 * lr * steps where every
    step's gradient is resolved (over 85% of them), within lr * steps (a
    bound on AdamW's steps) elsewhere, where rounding noise on a gradient
    near 0 moves a param by up to lr a step in either package."""
    n_resolved = sum(int(m.sum()) for m in resolved.values())
    assert n_resolved > 0.85 * sum(m.numel() for m in resolved.values())
    for name, r in ref.items():
        g = got[name]
        m = resolved.get(name, torch.ones_like(r, dtype=torch.bool))
        torch.testing.assert_close(g[m], r[m], atol=1e-3 * LR * STEPS, rtol=0,
                                   msg=lambda s: f"{name}: {s}")
        torch.testing.assert_close(g, r, atol=LR * STEPS, rtol=0,
                                   msg=lambda s: f"{name}: {s}")


def test_fsdp_checkpoint_equals_the_one_process_checkpoint(grid, mode="fsdp"):
    got, ref = grid[mode][0]["ckpt"], grid["one"]["ckpt"]
    assert grid["one"]["saved"] == grid[mode][0]["saved"] == list(range(1, STEPS + 1))
    assert list(got) == list(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == r.dtype and g.device.type == "cpu", name
        if not name.startswith(sd_weights.PREFIXES["unet"]):
            assert torch.equal(g, r), name      # frozen: the VAE and the text encoder
    _hold_params(got, ref, grid["one"]["resolved"])


@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
def test_tp_checkpoint_equals_the_one_process_checkpoint(grid, mode):
    """Rank 0's checkpoint of a tp grid (the tp pieces, and FSDP2's shards
    inside them, joined back): the one-process file's names in its order,
    shapes, dtypes, the frozen tensors bitwise."""
    test_fsdp_checkpoint_equals_the_one_process_checkpoint(grid, mode)


def test_a_nonfinite_fsdp_step_moves_nothing(grid):
    """The finite guard on sharded params: a NaN gradient (NaN noise) is
    seen by every rank through the whole gradient's norm, and the fused
    AdamW's found_inf leaves every DTensor shard as it was."""
    _hold_nan_step(grid, "nan")


def test_a_nonfinite_tp_step_moves_nothing(grid):
    """The same at tp 2: the norm of the whole gradient, a piece's squares
    summed over the tp ranks, is NaN on both, and no piece moves."""
    _hold_nan_step(grid, "tp_nan")


def _hold_nan_step(grid, mode):
    for r in grid[mode]:
        (m,) = r["metrics"]
        assert m["grads_finite"] == 0.0 and m["grad_norm"] == 0.0
    before = torch.load(os.path.join(grid["tmp"], "sd_w.pt"), weights_only=True)
    after = grid[mode][0]["ckpt"]
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)


def test_no_gradient_for_a_trainable_param_raises_on_a_grid():
    w, unused = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2))
    params = {"w": w, "unused": unused}
    loss = (w * 3).sum()
    grads = gradients(loss, lambda: params, {"w"}, None)       # one process: zeros
    assert torch.equal(grads["unused"], torch.zeros(2))
    grads = gradients((w * 3).sum(), lambda: params, {"w"}, {"dp": 1})   # frozen: zeros
    assert torch.equal(grads["w"], torch.full((2,), 3.0))
    with pytest.raises(RuntimeError, match="no gradient for the trainable param unused"):
        gradients((w * 3).sum(), lambda: params, {"w", "unused"}, {"dp": 1})


def test_glide_step_at_dp2_matches_the_one_process_step(grid):
    _hold_glide_step(grid, "glide")
    assert grid["glide"][1].keys() == {"metrics"}


def test_glide_step_at_tp2_matches_the_one_process_step(grid):
    _hold_glide_step(grid, "glide_tp")


def _hold_glide_step(grid, mode):
    one, ranks = grid["glide_one"], grid[mode]
    for r in ranks:
        for k in ("loss", "mse", "vlb", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], one["metrics"][k], rtol=1e-5,
                                       err_msg=k)
    for tree in ("params", "ema"):
        assert list(ranks[0][tree]) == list(one[tree])
        for n, ref in one[tree].items():
            g = one["grads"][n]
            resolved = (g.abs() > 1e-3 * g.abs().max()) | (g == 0)
            if n.startswith("xf.block_") and n.endswith(".qkv.bias"):
                # the xf's key biases: the softmax is shift-invariant along a row,
                # so their exact gradient is 0 and each run returns rounding noise
                resolved[tg.XF_KW["width"]:2 * tg.XF_KW["width"]] = False
            got = ranks[0][tree][n]
            assert got.shape == ref.shape and got.dtype == ref.dtype, (tree, n)
            torch.testing.assert_close(got[resolved], ref[resolved], atol=1e-3 * LR, rtol=0,
                                       msg=lambda s: f"{tree} {n}: {s}")
            torch.testing.assert_close(got, ref, atol=LR, rtol=0,
                                       msg=lambda s: f"{tree} {n}: {s}")


def test_lora_step_at_tp2_matches_the_one_process_step(grid):
    """3 LoRA steps (SD2-tiny at SD_GRID_UNET, rank 4, random lora_b) at tp
    2: lora_a / lora_b split where the rule splits them, (x A) gathered
    or reduced whole over the tp ranks."""
    one, ranks = grid["lora_one"], grid["lora_tp"]
    for r in ranks:
        for got, ref in zip(r["metrics"], one["metrics"]):
            for k in ("loss", "grad_norm", "mse_t_mean"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    got, ref = ranks[0]["ckpt"], one["ckpt"]
    before = torch.load(os.path.join(grid["tmp"], "lora_w.pt"), weights_only=True)
    assert list(got) == list(ref) and set(got) == set(before)
    for n, b in before.items():     # the adapters moved, nothing else
        assert torch.equal(got[n], b) == ("lora_" not in n), n
    _hold_params(got, ref, one["resolved"])


@pytest.mark.parametrize("mode", ["tp", "glide_tp", "lora_tp"])
def test_replicated_gradients_are_equal_on_the_tp_ranks(grid, mode):
    """Every param whole on both tp ranks ends the backward with the same
    gradient on each (bitwise), so the replicas stay equal; the pieces
    are 1/tp of the params whose param_spec holds "tp"."""
    (a, b) = (r["grads"] for r in grid[mode])
    assert a.keys() == b.keys() and len(a) > 0
    for n in a:
        assert torch.equal(a[n], b[n]), n
    if "shapes" in grid[mode][0]:
        shapes = grid[mode][0]["shapes"]
        ref = grid["one"]["ckpt"] if mode == "tp" else grid["lora_one"]["ckpt"]
        split = 0
        for n, shape in shapes.items():
            spec = port_mesh.param_spec(n, tuple(ref[n].shape), {"tp": 2})
            want = tuple(s // 2 if p == "tp" else s for s, p in zip(ref[n].shape, spec))
            assert shape == want, n
            split += "tp" in spec
        assert split == len(shapes) - len(a)


def test_txt2img_over_two_ranks(grid):
    one = grid["txt2img_one"]
    assert one.shape == (2, 64, 64, 3) and one.dtype == torch.uint8
    for r in grid["txt2img"]:
        assert torch.equal(r, one)
    assert np.abs(one.numpy().astype(np.int32) - grid["t_jax"].astype(np.int32)).max() <= 1


def test_adaptive_txt2img_over_two_ranks(grid):
    """build_txt2img(mesh=, sampler="dpm_adaptive") at dp 2: the solver's
    error norm spans both ranks' rows, so each rank makes the one-process
    call's UNet calls and returns its bytes."""
    one, calls = grid["txt2img_adaptive_one"]
    assert one.shape == (2, 64, 64, 3) and one.dtype == torch.uint8 and calls > 6
    for images, n in grid["txt2img_adaptive"]:
        assert n == calls
        assert torch.equal(images, one)


def test_txt2img_over_a_dp_tp_grid(grid):
    """build_txt2img(mesh=) at dp 2 x tp 2: the params stay whole, each tp
    rank of a data rank samples the same rows, the gather runs over the
    data ranks; every rank returns the one-process bytes."""
    for r in grid["txt2img_tp"]:
        assert torch.equal(r, grid["txt2img_one"])


def test_replicate_gives_every_rank_rank_0s_tensors(grid):
    assert grid["replicated"] == [[0.0] * 3, [0.0] * 3]


def test_train_clis_on_the_grid(grid):
    (s0, full0, own0), (s1, full1, own1) = grid["sd_cli"]
    assert s0 == s1 == 2 and full1 is None and own0 is None     # fsdp: shards
    ck = CheckpointManager(os.path.join(grid["tmp"], "sd_cli", "ckpt"))
    assert ck.steps() == [1]                                    # the initial save
    saved = ck.restore_latest()
    assert saved.keys() == full0.keys()
    models = common.build_sd("wukong", "fp32", torch.device("cpu"), tiny=True,
                             ckpt_path=ck.path(1))                # strict load
    assert models.unet.out[2].weight.shape == saved["model.diffusion_model.out.2.weight"].shape
    (g0, gfull, gown0), (g1, _, gown1) = grid["glide_cli"]
    assert g0 == g1 == 2
    assert all(torch.equal(gown0[k], gown1[k]) for k in gown0)   # dp: equal replicas
    assert all(torch.equal(gfull[k], gown0[k]) for k in gown0)
    gck = CheckpointManager(os.path.join(grid["tmp"], "glide_cli", "ckpt"))
    assert gck.steps() == [1, 2]
    latest = load_checkpoint(gck.path(2))
    assert all(torch.equal(latest["params"][k], gown0[k]) for k in gown0)

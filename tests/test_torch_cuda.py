"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card: every test carries the `cuda` marker and skips without
one. Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from minddiffusion_tpu_torch.models.layers import conv3x3_dispatch
from minddiffusion_tpu_torch.ops import (attention, attn_diag, attn_variants, conv3x3,
                                         flash_attention, fused_ff, glide_tail, gn_stats,
                                         winograd, winograd43)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("nq,c,heads", [(1024, 320, 5), (300, 512, 1), (1000, 128, 2),
                                        (1024, 320, 8), (300, 640, 8), (1000, 1280, 8)])
def test_packed_attention_kernel_matches_plain(cuda, nq, c, heads, exact):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, n, c, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, 512, 512))
    scale = (c // heads) ** -0.5
    ref = flash_attention.packed_attention_plain(q, k, v, heads, scale, exact)
    got = flash_attention.flash_attention_packed(q, k, v, heads, scale, exact)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,heads,d", [
    (2, 1024, 1024, 5, 64), (1, 300, 640, 2, 64), (2, 77, 130, 1, 64),
    (1, 1000, 1024, 1, 512), (2, 300, 640, 1, 512), (1, 40, 77, 1, 512),
    (3, 1, 1, 2, 64), (1, 65, 1, 2, 512),
    (2, 1024, 1024, 8, 40), (1, 300, 640, 8, 80), (1, 300, 640, 8, 160),
    (2, 77, 130, 3, 40), (1, 1, 1, 2, 160)])
def test_flash_attention_kernel_matches_plain(cuda, b, nq, nk, heads, d, exact):
    """K4 on (B, N, H, D), including Nq and Nk that are not tile multiples."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, n, heads, d, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, nk, nk))
    scale = d ** -0.5
    ref = flash_attention.flash_attention_plain(q, k, v, scale, exact)
    got = flash_attention.flash_attention(q, k, v, scale, exact)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160, 512])
def test_flash_attention_exact_kernel_holds_logits_above_88(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 520, 1, d, generator=g, device=cuda) for _ in range(3))
    q = (q * 40.0).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    assert logits.max().item() > 88.0
    ref = flash_attention.flash_attention_plain(q, k, v, scale, True)
    got = flash_attention.flash_attention(q, k, v, scale, True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
def test_winograd_kernel_matches_plain(cuda, gn):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 16, 12, 520, generator=g, device=cuda).to(torch.bfloat16)
    kern = torch.randn(3, 3, 520, 136, generator=g, device=cuda) * (9 * 520) ** -0.5
    u = winograd.transform_weights(kern).to(torch.bfloat16).contiguous()
    bias = torch.randn(136, generator=g, device=cuda)
    mult = 1.0 + 0.1 * torch.randn(2, 520, generator=g, device=cuda) if gn else None
    add = 0.1 * torch.randn(2, 520, generator=g, device=cuda) if gn else None
    ref = winograd.winograd_plain(x, u, bias, mult, add)
    got = winograd.conv3x3_winograd(x, u, bias, mult, add)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(8, 40), (8, 80), (8, 160), (5, 64), (1, 512)])
def test_packed_attention_exact_kernel_holds_logits_above_88(cuda, heads, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 512, heads * d, generator=g, device=cuda) for _ in range(3))
    q = (q * 40.0).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    scale = d ** -0.5
    logits = (q[0, :, :d].float() * scale) @ k[0, :, :d].float().T
    assert logits.max().item() > 88.0
    ref = flash_attention.packed_attention_plain(q, k, v, heads, scale, True)
    got = flash_attention.flash_attention_packed(q, k, v, heads, scale, True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("h,w,block_rows", [(16, 12, 32), (48, 20, 32), (14, 18, 6)])
def test_winograd_gathered_kernel_matches_plain(cuda, gn, h, w, block_rows):
    """K3 on one tile (H <= block_rows), on two with bottom padding (48 rows
    in tiles of 32), and on three."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, h, w, 520, generator=g, device=cuda).to(torch.bfloat16)
    kern = torch.randn(3, 3, 520, 136, generator=g, device=cuda) * (9 * 520) ** -0.5
    u = winograd.transform_weights(kern).to(torch.bfloat16).contiguous()
    bias = torch.randn(136, generator=g, device=cuda)
    mult = 1.0 + 0.1 * torch.randn(2, 520, generator=g, device=cuda) if gn else None
    add = 0.1 * torch.randn(2, 520, generator=g, device=cuda) if gn else None
    before = winograd.conv3x3_winograd_gathered.launches
    ref = winograd.winograd_gathered_plain(x, u, bias, mult, add, block_rows)
    got = winograd.conv3x3_winograd_gathered(x, u, bias, mult, add, block_rows)
    torch.cuda.synchronize()
    assert got.shape == (2, h, w, 136)
    assert winograd.conv3x3_winograd_gathered.launches == before + 1
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


def _wino_operands(g, device, b, h, w, ci, co, gn):
    x = torch.randn(b, h, w, ci, generator=g, device=device).to(torch.bfloat16)
    kern = torch.randn(3, 3, ci, co, generator=g, device=device) * (9 * ci) ** -0.5
    u = winograd.transform_weights(kern).to(torch.bfloat16).contiguous()
    bias = torch.randn(co, generator=g, device=device)
    mult = 1.0 + 0.1 * torch.randn(b, ci, generator=g, device=device) if gn else None
    add = 0.1 * torch.randn(b, ci, generator=g, device=device) if gn else None
    return x, u, bias, mult, add


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("gn", [True, False])
@pytest.mark.parametrize("b,h,w,ci,co", [
    (3, 16, 16, 576, 768),     # P 192: ragged against 128 tiles; C_out 768 = 12 x 64
    (1, 16, 24, 520, 136),     # B 1, H != W, C_in 520 (a partial 64-channel slice), C_out 136
    (2, 12, 20, 8, 8),         # the smallest widths the kernels take
    (1, 48, 48, 768, 200),     # P 576 over 5 row blocks, C_out 200 ragged against 64
])
def test_winograd_kernels_at_ragged_edges(cuda, gathered, gn, b, h, w, ci, co):
    """K2 and K3 against their plain versions where P, C_in or C_out is not a
    multiple of the fused kernel's block (128 tiles, 64 channels)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x, u, bias, mult, add = _wino_operands(g, cuda, b, h, w, ci, co, gn)
    if gathered:
        ref = winograd.winograd_gathered_plain(x, u, bias, mult, add)
        got = winograd.conv3x3_winograd_gathered(x, u, bias, mult, add)
    else:
        ref = winograd.winograd_plain(x, u, bias, mult, add)
        got = winograd.conv3x3_winograd(x, u, bias, mult, add)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, co) and torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("gn", [True, False])
def test_winograd_kernels_are_batch_position_independent(cuda, gathered, gn):
    """One image alone (B 1) and the same image at row 5 of a B-8 call give
    the same bytes: the kernels' sums do not depend on B, P or the row."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x, u, bias, mult, add = _wino_operands(g, cuda, 8, 16, 16, 640, 640, gn)
    conv = winograd.conv3x3_winograd_gathered if gathered else winograd.conv3x3_winograd
    batch = conv(x, u, bias, mult, add)
    alone = conv(x[5:6].contiguous(), u, bias, None if mult is None else mult[5:6].contiguous(),
                 None if add is None else add[5:6].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(alone[0], batch[5])


@pytest.mark.cuda
def test_dma_off_sends_winograd_sites_to_the_gathered_kernel(cuda, monkeypatch):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 16, 16, 512, generator=g, device=cuda).to(torch.bfloat16)
    weight = (torch.randn(64, 512, 3, 3, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
    bias = torch.zeros(64, device=cuda)
    k2, k3 = winograd.conv3x3_winograd.launches, winograd.conv3x3_winograd_gathered.launches
    a = conv3x3_dispatch(x, weight, bias)
    monkeypatch.setenv("MDT_WINO_TUNE", "dma=0")
    b = conv3x3_dispatch(x, weight, bias)
    torch.cuda.synchronize()
    assert winograd.conv3x3_winograd.launches == k2 + 1
    assert winograd.conv3x3_winograd_gathered.launches == k3 + 1
    err = (a.float() - b.float()).abs().max() / a.float().abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
def test_gated_sites_raise_on_cuda_inputs_the_kernels_do_not_take(cuda):
    """A kernel site with CUDA tensors the kernel does not take (here fp32)
    raises instead of running the plain version on the card."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 1024, 128, generator=g, device=cuda)
    with pytest.raises(TypeError):
        attention.packed_attention(q, q, q, heads=2)
    wide = torch.randn(1, 1100, 512, generator=g, device=cuda)   # a K4 site (nk % 128)
    with pytest.raises(TypeError):
        attention.packed_attention(wide, wide, wide, heads=1)
    x = torch.randn(1, 16, 16, 512, generator=g, device=cuda)
    weight = torch.randn(64, 512, 3, 3, generator=g, device=cuda)
    with pytest.raises(TypeError):
        conv3x3_dispatch(x, weight, torch.zeros(64, device=cuda))
    with pytest.raises(TypeError):
        winograd.conv3x3_winograd_gathered(
            x, torch.zeros(16, 512, 64, device=cuda, dtype=torch.bfloat16),
            torch.zeros(64, device=cuda))
    odd = torch.randn(1, 1024, 8 * 48, generator=g, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):   # D 48 is no SD width
        flash_attention.flash_attention_packed(odd, odd, odd, 8, 48 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,c,heads", [(2, 1024, 1152, 384, 6), (1, 256, 384, 768, 12)])
def test_packed_attention_kernel_at_the_glide_sites(cuda, b, nq, nk, c, heads):
    """K1 with the 128 text keys of a GLIDE site in front of the spatial ones
    (Nk = Nq + 128): the 32^2 sites, and the 16^2 tier of attn_route=256."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, nk, nk))
    scale = (c // heads) ** -0.5
    ref = flash_attention.packed_attention_plain(q, k, v, heads, scale)
    got = flash_attention.flash_attention_packed(q, k, v, heads, scale)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 2e-2


# (B, Nq, Nk, heads, D, the q rows of a CTA and the head groups packed_plan
# takes): each head width at each of its row tiers, with one group and with
# several, ragged Nq (1000, 300, 77, 65), Nk 77, Nq + 128 and 1, and C 120
# (boxes past C)
PACKED_CASES = [
    (1, 4096, 4096, 5, 64, 192, 5), (2, 1024, 1024, 10, 64, 128, 10),
    (2, 4096, 384, 20, 64, 64, 1), (2, 1000, 77, 5, 64, 128, 5),
    (2, 1000, 1128, 5, 64, 128, 5), (16, 1024, 1024, 10, 64, 128, 1),
    (1, 4096, 4096, 8, 40, 128, 1), (2, 1000, 77, 8, 40, 128, 1), (2, 4096, 77, 20, 40, 64, 1),
    (1, 300, 1152, 3, 40, 128, 1), (2, 1000, 1128, 8, 80, 128, 2),
    (2, 4096, 77, 16, 80, 64, 1), (2, 1000, 1128, 8, 160, 64, 4), (1, 77, 300, 2, 160, 64, 1),
    (1, 1000, 4096, 1, 512, 64, 1), (2, 300, 77, 1, 512, 64, 1), (1, 65, 1, 1, 512, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,heads,d,rows,groups", PACKED_CASES)
def test_packed_attention_kernel_at_every_width(cuda, b, nq, nk, heads, d, rows, groups,
                                                exact):
    """K1 at D 40 / 64 / 80 / 160 / 512, each row tier, heads in one CTA or
    split over several, any Nq and Nk: one launch of the CTAs its plan
    implies, finite, within 2e-2 of the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = flash_attention.packed_plan(nq, heads * d, heads, b, sms)
    assert (plan[0], plan[3]) == (rows, groups)
    g = torch.Generator(device=cuda).manual_seed(d + nk)
    q, k, v = (torch.randn(b, n, heads * d, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, nk, nk))
    scale = d ** -0.5
    before = flash_attention.flash_attention_packed.launches
    got = flash_attention.flash_attention_packed(q, k, v, heads, scale, exact)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_packed.launches == before + 1
    assert flash_attention.last_ctas["mdt_packed_attention"] == b * -(-nq // rows) * groups
    assert torch.isfinite(got.float()).all()
    ref = flash_attention.packed_attention_plain(q, k, v, heads, scale, exact)
    assert rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
def test_packed_attention_raises_on_shapes_without_a_plan(cuda):
    """D 512 takes one head, and D 48 is no width of the kernel: both raise
    on the card instead of running anything else."""
    two = torch.zeros(1, 256, 1024, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_packed(two, two, two, 2, 512 ** -0.5)
    odd = torch.zeros(1, 256, 8 * 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_packed(odd, odd, odd, 8, 48 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,h,w,c,co", [
    ("glide", 2, 32, 40, 192, 3), ("glide", 1, 17, 9, 64, 3),
    ("sd", 4, 16, 24, 320, 4), ("sd", 2, 9, 33, 40, 3)])
def test_glide_tail_kernel_matches_plain(cuda, mode, b, h, w, c, co):
    """K9 in both modes, at ragged tile edges and a channel count that is not
    a multiple of its 32-channel chunk."""
    g = torch.Generator(device=cuda).manual_seed(3)
    rand = lambda *s: torch.randn(*s, generator=g, device=cuda)  # noqa: E731
    bx = b // 2 if mode == "sd" else b
    args = [rand(b, h, w, c).to(torch.bfloat16), rand(bx, h, w, co), 1.0 + 0.2 * rand(b, c),
            0.2 * rand(b, c), rand(3, 3, c, co) * (9 * c) ** -0.5, 0.1 * rand(co),
            torch.tensor([1.7, 0.9, 0.8, 0.4] if mode == "glide" else [5.0, 1.02, -0.3, 0.0],
                         device=cuda)]
    before = glide_tail.tail_step.launches
    got = glide_tail.tail_step(*args, mode=mode)
    assert glide_tail.tail_step.launches == before + 1
    ref = glide_tail.PLAIN[mode](*args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max() / ref.abs().max()
    assert err.item() <= 2e-2


@pytest.mark.cuda
def test_glide_tail_raises_on_inputs_the_kernel_does_not_take(cuda):
    args = [torch.zeros(2, 8, 8, 36, device=cuda, dtype=torch.bfloat16),
            torch.zeros(2, 8, 8, 3, device=cuda), torch.ones(2, 36, device=cuda),
            torch.zeros(2, 36, device=cuda), torch.zeros(3, 3, 36, 3, device=cuda),
            torch.zeros(3, device=cuda), torch.zeros(4, device=cuda)]
    with pytest.raises(ValueError, match="C % 8"):           # C 36
        glide_tail.tail_step(*args)
    args[0] = torch.zeros(2, 8, 8, 36, device=cuda)
    with pytest.raises(TypeError):                            # fp32 h
        glide_tail.tail_step(*args)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def grads_of(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, g)


@pytest.mark.cuda
@pytest.mark.parametrize("c,heads,exact", [(320, 5, False), (320, 8, True), (512, 1, True),
                                           (640, 8, True), (1280, 8, False)])
def test_packed_attention_gradient_bridge(cuda, c, heads, exact):
    """K1 forward, einsum-attention backward, against autograd through the
    plain version; the backward launches no kernel."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, go = (torch.randn(2, 1024, c, generator=g, device=cuda).to(torch.bfloat16)
                   for _ in range(4))
    scale = (c // heads) ** -0.5
    before = flash_attention.flash_attention_packed.launches
    got = grads_of(lambda a, b, d: flash_attention.flash_attention_packed(
        a, b, d, heads, scale, exact), (q, k, v), go)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_packed.launches == before + 1
    ref = grads_of(lambda a, b, d: flash_attention.packed_attention_plain(
        a, b, d, heads, scale, exact), (q, k, v), go)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and rel_err(a, b) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 512])
def test_flash_attention_gradient_bridge(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(7)
    heads = 1 if d == 512 else 4
    q, go = (torch.randn(2, 300, heads, d, generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 640, heads, d, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    before = flash_attention.flash_attention.launches
    got = grads_of(lambda a, b, c: flash_attention.flash_attention(a, b, c, d ** -0.5),
                   (q, k, v), go)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    ref = grads_of(lambda a, b, c: flash_attention.flash_attention_plain(a, b, c, d ** -0.5),
                   (q, k, v), go)
    for a, b in zip(got, ref):
        assert rel_err(a, b) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("gathered", [False, True])
def test_winograd_gradient_bridge(cuda, gathered):
    """K2 / K3 forward on fp32 master weights, direct-conv backward, against
    autograd through the plain Winograd version; no kernel in the backward."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(2, 16, 16, 512, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(256, 512, 3, 3, generator=g, device=cuda) * (9 * 512) ** -0.5
    b = 0.1 * torch.randn(256, generator=g, device=cuda)
    go = torch.randn(2, 16, 16, 256, generator=g, device=cuda).to(torch.bfloat16)
    counter = winograd.conv3x3_winograd_gathered if gathered else winograd.conv3x3_winograd
    before = counter.launches
    got = grads_of(lambda a, c, e: winograd.conv3x3_winograd_ad(a, c, e, gathered),
                   (x, w, b), go)
    torch.cuda.synchronize()
    assert counter.launches == before + 1

    def plain(a, c, e):
        u = winograd.transform_weights(c.to(a.dtype).permute(2, 3, 1, 0)).to(a.dtype)
        return (winograd.winograd_gathered_plain if gathered else winograd.winograd_plain)(
            a, u, e)

    ref = grads_of(plain, (x, w, b), go)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
    for a, r in zip(got, ref):
        assert rel_err(a, r) <= 2e-2


@pytest.mark.cuda
def test_training_route_takes_the_bridge(cuda):
    """conv3x3_dispatch with a weight that requires grad: GN+SiLU applied
    elementwise, the kernel without its prologue, gradients reach every input."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(2, 16, 16, 512, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(64, 512, 3, 3, generator=g, device=cuda) * 0.02).requires_grad_(True)
    b = torch.zeros(64, device=cuda, requires_grad=True)
    gn = (1.0 + 0.1 * torch.randn(2, 512, generator=g, device=cuda),
          0.1 * torch.randn(2, 512, generator=g, device=cuda))
    y = conv3x3_dispatch(x, w, b, gn=gn)
    with torch.no_grad():
        ref = conv3x3_dispatch(x, w.to(torch.bfloat16), b, gn=gn)
    assert rel_err(y.detach(), ref) <= 2e-2
    y.float().square().mean().backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0 and b.grad.abs().sum() > 0


@pytest.mark.cuda
def test_training_route_carries_the_gn_gradient(cuda):
    """Only the GN affine requires grad: the conv still takes the training
    route, and the gradient reaches mult and add."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 16, 16, 512, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(64, 512, 3, 3, generator=g, device=cuda) * 0.02
    b = torch.zeros(64, device=cuda)
    mult = (1.0 + 0.1 * torch.randn(2, 512, generator=g, device=cuda)).requires_grad_(True)
    add = (0.1 * torch.randn(2, 512, generator=g, device=cuda)).requires_grad_(True)
    y = conv3x3_dispatch(x, w, b, gn=(mult, add))
    assert y.grad_fn is not None
    y.float().square().mean().backward()
    for t in (mult, add):
        assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 64, 320), (3, 17, 9, 640), (2, 16, 16, 1280),
                                   (1, 3, 5, 10)])
@pytest.mark.parametrize("transposed", [False, True])
def test_channel_sums_kernel_matches_plain(cuda, shape, transposed):
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    if transposed:
        x = x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
    before = gn_stats.channel_sums.launches
    s1, s2 = gn_stats.channel_sums(x, transposed)
    again = gn_stats.channel_sums(x, transposed)
    torch.cuda.synchronize()
    assert gn_stats.channel_sums.launches == before + 2
    r1, r2 = gn_stats.channel_sums_plain(x)
    assert rel_err(s1, r1) <= 1e-4 and rel_err(s2, r2) <= 1e-4
    assert torch.equal(s1, again[0]) and torch.equal(s2, again[1])   # no atomics


@pytest.mark.cuda
def test_channel_sums_vjp(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 8, 8, 64, generator=g, device=cuda).to(torch.bfloat16)
    g1, g2 = (torch.randn(2, 64, generator=g, device=cuda) for _ in range(2))
    (dx,) = grads_of(lambda a: gn_stats.channel_sums(a), (x,), (g1, g2))
    (ref,) = grads_of(lambda a: gn_stats.channel_sums_plain(a), (x,), (g1, g2))
    assert dx.dtype == torch.bfloat16 and rel_err(dx, ref) <= 1e-2
    with pytest.raises(ValueError, match="memory"):
        gn_stats.channel_sums(x.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(2, 300, 320), (1, 256, 640), (1, 100, 1280), (3, 1, 320)])
def test_fused_ff_kernel_matches_plain(cuda, b, n, c):
    g = torch.Generator(device=cuda).manual_seed(12)
    f = 4 * c
    rand = lambda *s: torch.randn(*s, generator=g, device=cuda)  # noqa: E731
    args = (rand(b, n, c).to(torch.bfloat16), 1.0 + 0.1 * rand(c), 0.1 * rand(c),
            rand(2 * f, c) * c ** -0.5, 0.1 * rand(2 * f), rand(c, f) * f ** -0.5, 0.1 * rand(c))
    before = fused_ff.fused_ln_geglu_ff.launches
    got = fused_ff.fused_ln_geglu_ff(*args)
    torch.cuda.synchronize()
    assert fused_ff.fused_ln_geglu_ff.launches == before + 1
    ref = fused_ff.fused_ff_plain(*args)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
def test_fused_ff_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 64, device=cuda, dtype=torch.bfloat16)
    w = [torch.zeros(64, device=cuda), torch.zeros(64, device=cuda),
         torch.zeros(512, 64, device=cuda), torch.zeros(512, device=cuda),
         torch.zeros(64, 256, device=cuda), torch.zeros(64, device=cuda)]
    with pytest.raises(ValueError, match="multiple of 320"):
        fused_ff.fused_ln_geglu_ff(x, *w)
    w[0] = w[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_ff.fused_ln_geglu_ff(x, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co", [(2, 16, 16, 64, 64), (1, 13, 21, 40, 136),
                                         (2, 8, 8, 256, 128), (1, 35, 70, 8, 16)])
def test_conv3x3_kernels_match_plain(cuda, b, h, w, ci, co):
    """K7 v1 and v2 (plain and with every fusion, bf16 and fp32 out) on
    ragged tiles (H, W not multiples of 8, 16) and C not multiples of 32."""
    g = torch.Generator(device=cuda).manual_seed(13)
    rand = lambda *s: torch.randn(*s, generator=g, device=cuda)  # noqa: E731
    x = rand(b, h, w, ci).to(torch.bfloat16)
    kern, bias = (rand(3, 3, ci, co) * (9 * ci) ** -0.5).to(torch.bfloat16), 0.1 * rand(co)
    cases = [(conv3x3.conv3x3_pallas, conv3x3.conv3x3_pallas_plain, {}),
             (conv3x3.conv3x3_gemm, conv3x3.conv3x3_gemm_plain, {}),
             (conv3x3.conv3x3_gemm, conv3x3.conv3x3_gemm_plain,
              dict(prologue_scale=1.0 + 0.1 * rand(b, ci), prologue_shift=0.2 * rand(b, ci),
                   silu_prologue=True, residual=rand(b, h, w, co).to(torch.bfloat16))),
             (conv3x3.conv3x3_gemm, conv3x3.conv3x3_gemm_plain,
              dict(silu_prologue=True, out_dtype=torch.float32))]
    for fn, plain, kw in cases:
        before = fn.launches
        got = fn(x, kern, bias, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = plain(x, kern, bias, **kw)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.isfinite(got.float()).all() and rel_err(got, ref) <= 2e-2, kw.keys()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co", [(2, 16, 16, 64, 64), (1, 12, 20, 40, 136),
                                         (2, 32, 32, 128, 256)])
def test_winograd43_kernel_matches_plain(cuda, b, h, w, ci, co):
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(b, h, w, ci, generator=g, device=cuda).to(torch.bfloat16)
    kern = torch.randn(3, 3, ci, co, generator=g, device=cuda) * (9 * ci) ** -0.5
    bias = 0.1 * torch.randn(co, generator=g, device=cuda)
    before = winograd43.conv3x3_winograd43.launches
    got = winograd43.conv3x3_winograd43(x, kern, bias)
    torch.cuda.synchronize()
    assert winograd43.conv3x3_winograd43.launches == before + 1
    ref = winograd43.conv3x3_winograd43_plain(x, kern, bias)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
def test_winograd43_gradient_bridge(cuda):
    """The kernel forward with the direct-conv backward: the gradient of x,
    the fp32 kernel and the bias against autograd through the plain F(4,3)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(2, 16, 16, 64, generator=g, device=cuda).to(torch.bfloat16)
    kern = torch.randn(3, 3, 64, 32, generator=g, device=cuda) * 0.05
    bias = 0.1 * torch.randn(32, generator=g, device=cuda)
    cot = torch.randn(2, 16, 16, 32, generator=g, device=cuda)
    grads = []
    for fn in (winograd43.conv3x3_winograd43_ad, winograd43.conv3x3_winograd43_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, kern, bias)]
        grads.append(torch.autograd.grad((fn(*leaves).float() * cot).sum(), leaves))
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        assert ((got.float() - ref.float()).norm() / ref.float().norm()).item() <= 5e-2


@pytest.mark.cuda
def test_conv_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="% 8 == 0"):
        conv3x3.conv3x3_pallas(x, torch.zeros(3, 3, 12, 16, device=cuda))
    with pytest.raises(ValueError, match="bf16"):
        conv3x3.conv3x3_gemm(x.float(), torch.zeros(3, 3, 12, 16, device=cuda))
    with pytest.raises(ValueError, match="H, W % 4 == 0"):
        winograd43.conv3x3_winograd43(torch.zeros(1, 6, 8, 16, device=cuda,
                                                  dtype=torch.bfloat16),
                                      torch.zeros(3, 3, 16, 16, device=cuda))


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("variant", ["ones", "fold", "k11"])
@pytest.mark.parametrize("b,nq,nk,c", [
    (2, 1024, 1024, 320), (1, 300, 77, 640), (1, 200, 328, 128), (3, 1, 1, 64),
    # ragged Nq with Nk 77, Nq + 128 and 1 at each row tier (192 rows with 5
    # head groups, 128, 64), and K11's ds4 shape, whose 64 CTAs of 64 rows
    # become 4 head groups of 128 rows
    (2, 2049, 77, 320), (2, 1000, 1128, 320), (2, 3199, 1, 704), (16, 256, 256, 1280)])
def test_ones_fold_kernels_match_plain(cuda, variant, b, nq, nk, c, exact):
    """K10a / K10b / K11 with ragged Nq and Nk, the ones column's row sum,
    launched on `ones_plan`'s grid."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, nk, nk))
    heads = c // 64
    fn = {"ones": attn_variants.flash_attention_packed_ones,
          "fold": attn_variants.flash_attention_packed_fold,
          "k11": attn_variants.ones_attention}[variant]
    ref = attn_variants.attn_ones_plain(q, k, attn_variants.augment_v(v, heads), 0.125,
                                        heads, exact)
    before = fn.launches
    got = fn(q, k, v, 0.125, heads, exact=exact)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rows, _, groups = attn_variants.ones_plan(b, nq, c, heads)
    assert attn_variants.last_ctas["mdt_attn_ones"] == -(-nq // rows) * b * groups
    assert _rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,nq,nk,c,c_out", [
    (2, 1024, 1024, 320, 320), (1, 300, 77, 640, 320), (1, 200, 328, 128, 136),
    (2, 64, 64, 1280, 1280),
    # Nq filling no tile (192 q rows a CTA up to C 448 at Nq >= 2048, else 128
    # up to C 640, else 64), Nk 1, 77 and Nq + 128 (keys past Nk are TMA's
    # zero fill), C_out 8 and 136 (a partial last 128-column Wo pass)
    (2, 1000, 1, 128, 8), (1, 65, 77, 128, 136), (2, 1000, 1128, 640, 136),
    (1, 65, 193, 640, 640), (1, 1000, 77, 704, 8), (2, 65, 1, 704, 704),
    (1, 1000, 1128, 1280, 136), (2, 65, 77, 1280, 1280), (1, 2100, 77, 320, 136),
    (1, 2049, 2177, 448, 8)])
def test_out_kernel_matches_plain(cuda, b, nq, nk, c, c_out, exact):
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda).to(torch.bfloat16)
               for n in (nq, nk, nk))
    wo = torch.randn(c, c_out, generator=g, device=cuda) * c ** -0.5
    bo = 0.1 * torch.randn(c_out, generator=g, device=cuda)
    ref = attn_variants.attn_out_plain(q, k, v, wo, bo, 0.125, c // 64, exact)
    before = attn_variants.flash_attention_packed_out.launches
    got = attn_variants.flash_attention_packed_out(q, k, v, wo, bo, 0.125, c // 64, exact)
    torch.cuda.synchronize()
    assert attn_variants.flash_attention_packed_out.launches == before + 1
    assert _rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("b,n,c,block_q", [(2, 1024, 320, 256), (1, 256, 640, 256),
                                           (2, 77, 128, 256),
                                           # every tier of the attention launch
                                           (1, 1000, 128, 1000), (2, 65, 640, 65),
                                           (1, 65, 704, 65), (1, 1000, 1280, 1000),
                                           (1, 2100, 320, 2100)])
def test_proj_kernel_matches_plain(cuda, b, n, c, block_q, exact):
    """K10c, and its projection launch alone against the rounded products."""
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn(b, n, c, generator=g, device=cuda).to(torch.bfloat16)
    wq, wk, wv, wo = (torch.randn(c, c, generator=g, device=cuda) * c ** -0.5
                      for _ in range(4))
    bo = 0.1 * torch.randn(c, generator=g, device=cuda)
    args = (x, wq, wk, wv, wo, bo, 0.125, c // 64)
    ref = attn_variants.attn_proj_plain(*args, exact)
    before = attn_variants.flash_attention_packed_proj.launches
    got = attn_variants.flash_attention_packed_proj(*args, block_q=block_q, exact=exact)
    torch.cuda.synchronize()
    assert attn_variants.flash_attention_packed_proj.launches == before + 1
    assert _rel_err(got, ref) <= 2e-2
    y = attn_variants._proj_qkv(x, wq, wk, wv, 0.125)
    wqs = (wq.float() * 0.125).to(torch.bfloat16)
    y_ref = torch.cat([torch.matmul(x.float(), w.to(torch.bfloat16).float()).to(torch.bfloat16)
                       for w in (wqs, wk, wv)], dim=-1)
    assert _rel_err(y, y_ref) <= 2e-2


@pytest.mark.cuda
def test_attn_variant_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 64, 320, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        attn_variants.flash_attention_packed_ones(q, q, q, 0.125, 5)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        attn_variants.ones_attention(qb, qb, qb, 0.125, 4)
    w = torch.zeros(320, 100, device=cuda)
    with pytest.raises(ValueError, match="C_out % 8"):
        attn_variants.flash_attention_packed_out(qb, qb, qb, w, torch.zeros(100, device=cuda),
                                                 0.125, 5)


def _diag_launches() -> int:
    return sum(f.launches for f in (attn_diag.diag, attn_diag.diag_kt, attn_diag.diag_slice,
                                    attn_diag.diag_bf16s))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(attn_diag.variants()))
@pytest.mark.parametrize("b,n,c", [
    (2, 256, 128), (1, 512, 320),
    # each row tier of `diag_plan` (192 rows with 5 head groups; 64 rows,
    # 100 CTAs), and 440 CTAs of 192 rows, 3.3 waves on 132 SMs
    (2, 2048, 320), (2, 3200, 704), (4, 4096, 320)])
def test_attn_diag_kernel_matches_plain(cuda, name, b, n, c):
    """K12, each mode, on randn inputs (logits well below 88), each output
    within 2e-2 of its scale (`hold_scale`: row by row, or output by output,
    for the raw exp modes), launched on `diag_plan`'s grid."""
    heads = c // 64
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(b, n, c, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    fn, plain = attn_diag.variants()[name]
    before = _diag_launches()
    attn_diag.last_ctas.clear()
    got = fn(q, k, v, heads)
    torch.cuda.synchronize()
    assert _diag_launches() == before + 1
    rows, _, groups = attn_diag.diag_plan(attn_diag.PLAN_MODES[name], b, n, c, heads)
    assert list(attn_diag.last_ctas.values()) == [-(-n // rows) * b * groups]
    ref = plain(q, k, v, heads)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    scale = attn_diag.hold_scale(name, ref, heads)
    allowance = 0.0
    if name.startswith("diag_bf16s"):   # a score's last bits at a bf16 rounding midpoint
        table = attn_diag.exp_bf16x2_table(cuda) if name == "diag_bf16s_ex2" else None
        allowance = attn_diag.bf16s_rounding_bound(q, k, v, heads, table)
    assert ((got.float() - ref.float()).abs() <= 2e-2 * scale + allowance).all()


@pytest.mark.cuda
def test_attn_diag_overflows_where_the_plain_version_does(cuda):
    """No scale and no max: a row whose diagonal logit passes 88 is inf or
    NaN in the kernel as in the plain version (q = k = v, one row scaled),
    in every mode with an exp."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(1, 128, 128, generator=g, device=cuda) * 0.5
    x[0, 5] *= 3.0                                  # |x_5|^2 per head ~ 144 > 88
    x = x.to(torch.bfloat16)
    for name in ("diag_exp", "diag_full", "diag_fp32pv", "diag_bf16s", "diag_bf16s_ex2",
                 "diag_kt_full", "diag_qkexp_slice"):
        fn, plain = attn_diag.variants()[name]
        got, ref = fn(x, x, x, 2), plain(x, x, x, 2)
        torch.cuda.synchronize()
        overflow = ~torch.isfinite(got[0, 5].float())
        # expslice keeps keys 0-63, of which only key 5 passes 88
        assert overflow.any() if name == "diag_qkexp_slice" else overflow.all(), name
        assert torch.equal(torch.isfinite(got.float()), torch.isfinite(ref.float())), name


@pytest.mark.cuda
def test_attn_diag_refusals(cuda):
    q = torch.zeros(1, 128, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        attn_diag.diag(q.float(), q.float(), q.float(), 2, "full")
    with pytest.raises(ValueError, match="multiple of 64"):
        attn_diag.diag(q[:, :100], q[:, :100], q[:, :100], 2, "full")
    with pytest.raises(ValueError, match="head dim"):
        attn_diag.diag_bf16s(q, q, q, 4)
    with pytest.raises(ValueError, match="mode"):
        attn_diag.diag_kt(q, q, q, 2, "exp")

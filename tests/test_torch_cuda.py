"""The port's CUDA kernels against their plain PyTorch versions.

Needs a CUDA card: every test carries the `cuda` marker and skips without
one. Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from minddiffusion_tpu_torch.models.layers import conv3x3_dispatch
from minddiffusion_tpu_torch.ops import attention, flash_attention, glide_tail, winograd


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
@pytest.mark.parametrize("heads,d", [(8, 40), (8, 80), (8, 160)])
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

"""Winograd F(2x2, 3x3) conv: the two hand-written Hopper kernels and their
plain versions.

Ports of minddiffusion_tpu/ops/winograd.py `conv3x3_winograd`, a 3x3
stride-1 same-pad conv on NHWC activations with an optional GroupNorm+SiLU
prologue folded to a per-(batch, channel) affine `silu(x * mult + add)`:
  * `conv3x3_winograd` (K2), its DMA path (`_wino_kernel_dma_gn` /
    `_wino_kernel_dma` through `_wino_compute`): the kernel reads the
    activation and its halo itself and applies the prologue in fp32;
  * `conv3x3_winograd_gathered` (K3), its gather path (`_wino_kernel`, taken
    under MDT_WINO_TUNE=dma=0): the prologue runs on the host (rounded to
    the activation dtype), the host pads and gathers overlapping row windows
    into a tile array (`gather_tiles`), and the kernel reads that array.
Both kernels are in csrc/winograd.cu; they differ in the input transform and
share the fused kernel that runs the 16 products and the output transform.

B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
G   = [[1,0,0],[.5,.5,.5],[.5,-.5,.5],[0,0,1]]
A^T = [[1,1,1,0],[0,1,-1,-1]]

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from minddiffusion_tpu_torch.ops import _build
from minddiffusion_tpu_torch.utils.flags import flags

_SIGNATURES = {
    "mdt_winograd_conv3x3": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "mdt_winograd_conv3x3_gathered": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}
BLOCK_ROWS = 32   # rows of a gathered tile (the JAX `block_rows` default)

_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C_in, C_out) -> U (16, C_in, C_out) = G k G^T, fp32."""
    # copied without a stream synchronisation (a pageable host copy with
    # non_blocking is staged before the call returns)
    g = torch.tensor(_G, dtype=torch.float32).to(kernel.device, non_blocking=True)
    k = kernel.float()
    u = torch.einsum("ar,rsco->asco", g, k)
    u = torch.einsum("bs,asco->abco", g, u)
    return u.reshape(16, *kernel.shape[2:])


MIN_C_IN = 512
MAX_SIDE = 48


def wino_route(h: int, w: int, c_in: int) -> bool:
    """Shape gate of the JAX package (`wino_wins`) without its TPU VMEM cap:
    H, W even, 12 <= min(H, W) <= MAX_SIDE (48), C_in >= MIN_C_IN (512);
    MDT_WINO_TUNE hmax= / cmin= replace the 48 and the 512. False at every
    shape under MDT_WINO=0."""
    f = flags()
    if not f.wino:
        return False
    h_max = f.wino_hmax if f.wino_hmax is not None else MAX_SIDE
    c_min = f.wino_cmin if f.wino_cmin is not None else MIN_C_IN
    return h % 2 == 0 and w % 2 == 0 and 12 <= min(h, w) <= h_max and c_in >= c_min


def kernel_supports(x: torch.Tensor, c_out: int) -> bool:
    return x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0 and c_out % 8 == 0


def _transform_gemms(d, u: torch.Tensor, bias: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """d[i][j] (..., C_in): element (i, j) of every 4x4 input patch, fp32.
    V = B^T d B rounded to `dtype`, the 16 fp32-accumulated GEMMs with U,
    Y = A^T M A + bias -> (P, 2, 2, C_out) fp32, P the patch count."""
    c_in = u.shape[1]
    cols = [[r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3]] for r in d]
    uf = u.to(dtype).float()
    m = {}
    for bb in range(4):
        r = [cols[i][bb] for i in range(4)]
        va = (r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3])
        for a in range(4):
            v = va[a].to(dtype).float().reshape(-1, c_in)
            m[(a, bb)] = torch.matmul(v, uf[4 * a + bb])       # (P, C_out)
    bias = bias.float()
    p0 = [m[(0, bb)] + m[(1, bb)] + m[(2, bb)] for bb in range(4)]
    p1 = [m[(1, bb)] - m[(2, bb)] - m[(3, bb)] for bb in range(4)]
    return torch.stack([
        torch.stack([p[0] + p[1] + p[2] + bias, p[1] - p[2] - p[3] + bias], 1)
        for p in (p0, p1)], 1)                                 # (P, 2, 2, C_out)


def winograd_plain(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                   gn_mult: Optional[torch.Tensor] = None,
                   gn_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's algorithm in torch ops. x (B, H, W, C_in), u (16, C_in, C_out),
    bias (C_out,) -> (B, H, W, C_out) in x's dtype. The prologue runs in
    fp32 on the unpadded input, so the padding stays exactly zero; V is
    rounded to x's dtype before the 16 fp32-accumulated GEMMs."""
    b, h, w, _ = x.shape
    c_out = u.shape[-1]
    xf = x.float()
    if gn_mult is not None:
        xf = xf * gn_mult[:, None, None, :] + gn_add[:, None, None, :]
        xf = xf * torch.sigmoid(xf)
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    d = [[xp[:, i:i + h:2, j:j + w:2, :] for j in range(4)] for i in range(4)]
    y = _transform_gemms(d, u, bias, x.dtype)
    y = y.reshape(b, h // 2, w // 2, 2, 2, c_out).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h, w, c_out).to(x.dtype)


def gather_tiles(x: torch.Tensor, gn_mult: Optional[torch.Tensor] = None,
                 gn_add: Optional[torch.Tensor] = None,
                 block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The host side of K3 (JAX `_conv3x3_winograd_jit` with dma=False): the
    GN+SiLU prologue in fp32, rounded to x's dtype; zero padding to
    (n_tiles * bh + 2, W + 4) (1 row on top, 1 + the row padding below, 1
    column left, 3 right); the overlapping (bh + 2)-row windows gathered into
    (B, n_tiles, bh + 2, W + 4, C_in), bh = min(block_rows, H) rounded up to
    even. In x's dtype, contiguous."""
    b, h, w, c_in = x.shape
    if gn_mult is not None:
        xf = x.float() * gn_mult[:, None, None, :] + gn_add[:, None, None, :]
        x = (xf * torch.sigmoid(xf)).to(x.dtype)
    bh = min(block_rows, h)
    bh += bh % 2
    pad_h = (-h) % bh
    n_tiles = (h + pad_h) // bh
    xp = torch.nn.functional.pad(x, (0, 0, 1, 3, 1, 1 + pad_h))
    rows = (torch.arange(n_tiles, device=x.device)[:, None] * bh
            + torch.arange(bh + 2, device=x.device)[None, :])
    return xp[:, rows]                           # (B, n_tiles, bh + 2, W + 4, C_in)


def winograd_tiles_plain(tiles: torch.Tensor, u: torch.Tensor,
                         bias: torch.Tensor, h: int) -> torch.Tensor:
    """K3's kernel in torch ops: tiles (B, n_tiles, bh + 2, W + 4, C_in) ->
    (B, h, W, C_out) in the tiles' dtype (the stacked padded height cut to h)."""
    b, n_tiles, bh2, w4, _ = tiles.shape
    bh, w = bh2 - 2, w4 - 4
    c_out = u.shape[-1]
    tf = tiles.float()
    d = [[tf[:, :, i:i + bh:2, j:j + w:2, :] for j in range(4)] for i in range(4)]
    y = _transform_gemms(d, u, bias, tiles.dtype)
    y = y.reshape(b, n_tiles, bh // 2, w // 2, 2, 2, c_out).permute(0, 1, 2, 4, 3, 5, 6)
    return y.reshape(b, n_tiles * bh, w, c_out)[:, :h].to(tiles.dtype)


def winograd_gathered_plain(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                            gn_mult: Optional[torch.Tensor] = None,
                            gn_add: Optional[torch.Tensor] = None,
                            block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The plain version of `conv3x3_winograd_gathered`: the same host
    gather, then `winograd_tiles_plain`."""
    tiles = gather_tiles(x, gn_mult, gn_add, block_rows)
    return winograd_tiles_plain(tiles, u, bias, x.shape[1])


def _check(checks, x: torch.Tensor) -> None:
    for name, t, dt, shape in checks:
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(t.shape)}")


def _check_aligned(x: torch.Tensor, u: torch.Tensor) -> None:
    """The kernels read their input (x or the tile array) in 8-byte and U
    (by TMA) in 16-byte units."""
    if x.data_ptr() % 8 or u.data_ptr() % 16:
        raise ValueError("the input must be 8-byte and u 16-byte aligned")


def conv3x3_winograd(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                     gn_mult: Optional[torch.Tensor] = None,
                     gn_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x NHWC (H, W even), u (16, C_in, C_out) from `transform_weights`,
    bias (C_out,) fp32, optional gn_mult/gn_add (B, C_in) fp32. Counts its
    kernel launches in `conv3x3_winograd.launches`."""
    if (gn_mult is None) != (gn_add is None):
        raise ValueError("gn_mult and gn_add go together")
    if x.device.type == "cpu":
        return winograd_plain(x, u, bias, gn_mult, gn_add)
    b, h, w, c_in = x.shape
    c_out = u.shape[-1]
    checks = [("x", x, torch.bfloat16, (b, h, w, c_in)),
              ("u", u, torch.bfloat16, (16, c_in, c_out)),
              ("bias", bias, torch.float32, (c_out,))]
    if gn_mult is not None:
        checks += [("gn_mult", gn_mult, torch.float32, (b, c_in)),
                   ("gn_add", gn_add, torch.float32, (b, c_in))]
    _check(checks, x)
    if x.device.type != "cuda" or h % 2 or w % 2 or not kernel_supports(x, c_out):
        raise ValueError(f"kernel takes CUDA bf16 NHWC with H, W even and "
                         f"C_in, C_out % 8 == 0; got {tuple(x.shape)} -> {c_out}")
    _check_aligned(x, u)
    p = b * (h // 2) * (w // 2)
    vbuf = torch.empty((16, p, c_in), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((b, h, w, c_out), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("winograd", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_winograd_conv3x3(
            x.data_ptr(), u.data_ptr(), bias.data_ptr(),
            None if gn_mult is None else gn_mult.data_ptr(),
            None if gn_add is None else gn_add.data_ptr(),
            vbuf.data_ptr(), out.data_ptr(), b, h, w, c_in, c_out, stream)
    _build.check(err, "winograd launch")
    conv3x3_winograd.launches += 1
    return out


conv3x3_winograd.launches = 0


def conv3x3_winograd_gathered(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor,
                              gn_mult: Optional[torch.Tensor] = None,
                              gn_add: Optional[torch.Tensor] = None,
                              block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """K3: x NHWC (H, W even), u (16, C_in, C_out), bias (C_out,) fp32,
    optional gn_mult/gn_add (B, C_in) fp32, applied on the host. Builds the
    tile array with `gather_tiles` and runs the kernel on it. Counts its
    kernel launches in `conv3x3_winograd_gathered.launches`."""
    if (gn_mult is None) != (gn_add is None):
        raise ValueError("gn_mult and gn_add go together")
    if x.device.type == "cpu":
        return winograd_gathered_plain(x, u, bias, gn_mult, gn_add, block_rows)
    b, h, w, c_in = x.shape
    c_out = u.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be {torch.bfloat16}, got {x.dtype}")
    checks = [("u", u, torch.bfloat16, (16, c_in, c_out)),
              ("bias", bias, torch.float32, (c_out,))]
    if gn_mult is not None:
        checks += [("gn_mult", gn_mult, torch.float32, (b, c_in)),
                   ("gn_add", gn_add, torch.float32, (b, c_in))]
    _check(checks, x)
    if x.device.type != "cuda" or h % 2 or w % 2 or not kernel_supports(x, c_out):
        raise ValueError(f"kernel takes CUDA bf16 NHWC with H, W even and "
                         f"C_in, C_out % 8 == 0; got {tuple(x.shape)} -> {c_out}")
    tiles = gather_tiles(x, gn_mult, gn_add, block_rows)
    _check_aligned(tiles, u)
    n_tiles, bh = tiles.shape[1], tiles.shape[2] - 2
    p = b * n_tiles * (bh // 2) * (w // 2)
    vbuf = torch.empty((16, p, c_in), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((b, n_tiles * bh, w, c_out), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("winograd", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mdt_winograd_conv3x3_gathered(
            tiles.data_ptr(), u.data_ptr(), bias.data_ptr(), vbuf.data_ptr(),
            out.data_ptr(), b, n_tiles, bh, w, c_in, c_out, stream)
    _build.check(err, "winograd gathered launch")
    conv3x3_winograd_gathered.launches += 1
    return out if out.shape[1] == h else out[:, :h].contiguous()


conv3x3_winograd_gathered.launches = 0


def _direct_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The direct 3x3 conv in the operands' dtype (x's), bias added after:
    the function whose gradient the Winograd kernels take (JAX `_direct_ref`;
    a mixed bf16-operand / fp32-output conv has no transpose there)."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1) + bias.to(x.dtype)


class _WinogradConvFn(torch.autograd.Function):
    """K2 (or K3) forward on U = G k G^T of the weight rounded to x's dtype,
    direct-conv backward (JAX `conv3x3_winograd_ad`,
    minddiffusion_tpu/ops/winograd.py:548-576). No kernel runs in the
    backward pass."""

    @staticmethod
    def forward(ctx, x, weight, bias, gathered):
        ctx.save_for_backward(x, weight, bias)
        u = transform_weights(weight.to(x.dtype).permute(2, 3, 1, 0)).to(x.dtype).contiguous()
        conv = conv3x3_winograd_gathered if gathered else conv3x3_winograd
        return conv(x, u, bias.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, weight, bias)]
            y = _direct_conv(*leaves)
            grads = torch.autograd.grad(y, leaves, g.to(y.dtype))
        return (*grads, None)


def conv3x3_winograd_ad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        gathered: bool = False) -> torch.Tensor:
    """The training route of a Winograd-gated conv: x NHWC, weight OIHW (any
    float dtype, e.g. fp32 master weights), bias (C_out,). Runs K2 (K3 when
    `gathered`) with no prologue and no cached U, differentiable through the
    direct conv. CPU tensors take the same plain versions as the kernels'
    wrappers, differentiated through the Winograd algorithm itself."""
    if x.device.type == "cpu":
        u = transform_weights(weight.to(x.dtype).permute(2, 3, 1, 0)).to(x.dtype)
        plain = winograd_gathered_plain if gathered else winograd_plain
        return plain(x, u, bias)
    return _WinogradConvFn.apply(x.contiguous(), weight, bias, gathered)

"""Self-attention at the sites with 1024 query tokens or more (the UNet's
two finest levels, the VAE decoder's middle block) in one txt2img batch:
QK^T and PV on the tensor cores, one fp32 exp a score, q, k, v read and
the output written once in bf16. The first UNet site runs once for both
guidance halves (the CFG-prefix saving)."""
from portbench import work

MIN_TOKENS = 1024


def sites(config: dict, traffic: dict):
    return [r for r in work.txt2img_batch(config, traffic)
            if r[0] == "attn" and r[6] == "self" and r[3] >= MIN_TOKENS]


def work_of(config: dict, traffic: dict) -> dict:
    flops = exps = nbytes = 0.0
    for _, rows, heads, nq, nk, d, _, _ in sites(config, traffic):
        flops += 4.0 * rows * heads * nq * nk * d
        exps += float(rows * heads * nq * nk)
        nbytes += 2.0 * rows * heads * d * (2 * nq + 2 * nk)
    return {"flops": flops, "exps": exps, "bytes": nbytes}

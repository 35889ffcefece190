"""The stride-1 3x3 convolutions with outputs of 16 x 16 or more (the
UNet's three finest levels and the VAE decoder) in one txt2img batch,
counted at the multiplications of Winograd F(4x4, 3x3), 36 for 16 outputs
(the fewest of any algorithm the port holds), each a multiply-add; input,
weights and output read or written once in bf16. No route can read above
its bound; the share reads low by design. The UNet's first convs run once
for both guidance halves (the CFG-prefix saving)."""
from portbench import work

MIN_SIDE = 16
MULTS_PER_OUTPUT = 36 / 16


def sites(config: dict, traffic: dict):
    return [r for r in work.txt2img_batch(config, traffic)
            if r[0] == "conv3x3" and r[6] == 1 and min(r[2], r[3]) >= MIN_SIDE]


def work_of(config: dict, traffic: dict) -> dict:
    flops = nbytes = 0.0
    for _, rows, h, w, ci, co, _, _ in sites(config, traffic):
        flops += 2.0 * MULTS_PER_OUTPUT * rows * h * w * ci * co
        nbytes += 2.0 * (rows * h * w * (ci + co) + 9 * ci * co)
    return {"flops": flops, "exps": 0.0, "bytes": nbytes}

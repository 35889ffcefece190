"""The seeded traffic: the same for a seed, different across seeds, and
the same sizes for every seed."""
import torch

from portbench import harness, sd
from portbench.traffic import train

SEED = 2**31 + 77
SD2 = harness.resolve("sd2-t2i-ddim50-b8")
FT = harness.resolve("wukong-ft-512-b8")
CPU = torch.device("cpu")


def _gen(seed, k=0):
    cond, uncond = sd.prompt_tokens(SD2.config, SD2.traffic, seed, k, 8, CPU)
    noise = sd.latent_noise(SD2.config, SD2.traffic, seed, k, 8, CPU)
    return cond, uncond, noise


def test_generate_inputs_seeded():
    a, b, c = _gen(SEED), _gen(SEED), _gen(SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])
    assert not torch.equal(a[2], _gen(SEED, 1)[2])
    assert a[0].shape == c[0].shape == (8, 77) and a[2].shape == (8, 64, 64, 4)
    tok = SD2.config["tokens"]
    assert (a[0][:, 0] == tok["bos"]).all() and (a[0] == tok["eos"]).sum() == 8
    assert torch.equal(a[1][0, :2], torch.tensor([tok["bos"], tok["eos"]]))


def test_train_batches_seeded():
    small = dict(FT.traffic, image_size=64, batch=2)
    x, d = train.batch_of(FT.config, small, SEED, 3, CPU)
    y, e = train.batch_of(FT.config, small, SEED, 3, CPU)
    z, f = train.batch_of(FT.config, small, SEED + 5, 3, CPU)
    assert torch.equal(x["image"], y["image"]) and torch.equal(d["noise"], e["noise"])
    assert not torch.equal(x["image"], z["image"]) and not torch.equal(d["t"], f["t"])
    assert x["image"].abs().max() <= 1.0 and x["image"].shape == (2, 64, 64, 3)


def test_large_seed():
    assert harness.sub_seed(2**33 + 5, "x", 1) != harness.sub_seed(2**33 + 6, "x", 1)
    assert 0 <= harness.sub_seed(2**40, "noise", -1) < 2**63


def test_serve_schedule():
    """The same arrivals for every seed; prompts and request seeds seeded."""
    from portbench.traffic import serve

    p = harness.resolve("sd2-serve-dpm20-b8").traffic
    a, b, c = (serve.schedule(p, s, 50.0) for s in (SEED, SEED, SEED + 1))
    assert a == b
    assert [r["due"] for r in a] == [r["due"] for r in c]
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]
    assert len({r["seed"] for r in a}) == len(a)
    assert 0.8 * p["rate"] * 50 < len(a) <= p["rate"] * 50
    ids = serve.toy_tokenize(a[0]["prompt"], harness.resolve("sd2-serve-dpm20-b8").config)
    assert ids.shape == (77,) and ids[0] == 49406

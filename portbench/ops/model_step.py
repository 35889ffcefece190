"""Model FLOPs of one step of a cell, direct algorithm (work.flops): a
txt2img batch (text encoder, every UNet evaluation, VAE decode), or a
training step (VAE encode, text forward, the UNet's forward and backward)
for every sample of the batch."""
from portbench import work


def txt2img(config: dict, traffic: dict) -> float:
    return sum(work.flops(r) for r in work.txt2img_batch(config, traffic))


def train(config: dict, traffic: dict) -> float:
    return traffic["batch"] * sum(work.flops(r) for r in work.train_sample(config, traffic))

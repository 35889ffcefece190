"""Serving: micro-batching engine + stdlib HTTP front end (port of
minddiffusion_tpu/serving). A long-lived process holds one pipeline at a
fixed batch size and micro-batches request traffic onto it."""
from minddiffusion_tpu_torch.serving.engine import BatchingEngine, GlideAdapter, SDAdapter
from minddiffusion_tpu_torch.serving.http_server import make_server

__all__ = ["BatchingEngine", "GlideAdapter", "SDAdapter", "make_server"]

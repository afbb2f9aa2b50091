"""
Online synthesis serving on one device (the counterpart of gance_tpu/serving/,
without its multi-host control channel): dynamic request batching
(batcher.py), a stdlib HTTP daemon (daemon.py) with the audio routes
(audio.py), and its client (client.py). Serving over a mesh or processes
that span one is ROADMAP.md Queue 1 item 12, part 2.
"""

from gance_tpu_torch.serving.audio import (
    AudioRequestError,
    plan_audio_request,
    synthesize_plan,
)
from gance_tpu_torch.serving.batcher import DynamicBatcher, bucket_rows, default_max_batch
from gance_tpu_torch.serving.client import ServingClient, ServingClientError
from gance_tpu_torch.serving.daemon import SynthesisDaemon

__all__ = [
    "AudioRequestError",
    "plan_audio_request",
    "synthesize_plan",
    "DynamicBatcher",
    "ServingClient",
    "ServingClientError",
    "SynthesisDaemon",
    "bucket_rows",
    "default_max_batch",
]

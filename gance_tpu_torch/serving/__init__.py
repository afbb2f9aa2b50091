"""
Online synthesis serving (the counterpart of gance_tpu/serving/): dynamic
request batching (batcher.py), a stdlib HTTP daemon (daemon.py) with the
audio routes (audio.py), its client (client.py), and the control channel
that serves over a mesh spanning several processes (multihost.py).
"""

from gance_tpu_torch.serving.audio import (
    AudioRequestError,
    plan_audio_request,
    synthesize_plan,
)
from gance_tpu_torch.serving.batcher import DynamicBatcher, bucket_rows, default_max_batch
from gance_tpu_torch.serving.client import ServingClient, ServingClientError
from gance_tpu_torch.serving.daemon import SynthesisDaemon
from gance_tpu_torch.serving.multihost import (
    ControlCoordinator,
    ControlWorker,
    MultiHostNetwork,
    MultiHostServingError,
    run_worker,
    wrap_networks_for_multihost,
)

__all__ = [
    "AudioRequestError",
    "ControlCoordinator",
    "ControlWorker",
    "MultiHostNetwork",
    "MultiHostServingError",
    "run_worker",
    "wrap_networks_for_multihost",
    "plan_audio_request",
    "synthesize_plan",
    "DynamicBatcher",
    "ServingClient",
    "ServingClientError",
    "SynthesisDaemon",
    "bucket_rows",
    "default_max_batch",
]

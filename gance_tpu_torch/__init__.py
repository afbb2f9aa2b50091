"""
gance_tpu_torch — the PyTorch/CUDA port of gance_tpu.

It runs StyleGAN2 (config-f family) on an NVIDIA GPU with the same TF-format
`.pkl` networks, the same z / w+ inputs and the same uint8 NHWC frames as
`gance_tpu`:
  * frame synthesis (`synthesis/runtime.py`: `SynthesisNetwork`,
    `MultiNetwork`), on the standard path or the polyphase top block;
  * training on one device (`parallel/training.py`, `cli/train.py`);
  * the noise-blend pipeline, a WAV in and a music video out
    (`pipelines/noise_blend.py`, `cli/music_into_networks.py noise-blend`):
    the audio DSP in torch on the device (`audio/`), the inputs and
    orchestration (`synthesis/inputs.py`, `orchestration.py`) and the video
    egress with the audio track (`media/`, the native AVI muxer bound in
    `media/native`).

Activations are NCHW and conv weights OIHW. The five kernels that `gance_tpu`
wrote in Pallas (the noise/bias/lrelu epilogue, the skip-chain 2x upsample,
the post-transpose-conv blur, the general 4x4 blur of the discriminator and
the gradients, and the polyphase top block's Conv1 + ToRGB) are hand-written
CUDA under `ops/cuda/csrc/`, built with nvcc at first use.

The package imports torch and never jax or gance_tpu. Entry points run on
`device="cuda"` unless the caller asks for the CPU, where every kernel wrapper
uses its plain PyTorch twin.
"""

__version__ = "0.1.0"

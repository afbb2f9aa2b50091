"""
gance_tpu_torch — the PyTorch/CUDA port of gance_tpu's frame synthesis.

It runs StyleGAN2 (config-f family) synthesis on an NVIDIA GPU: the same
TF-format `.pkl` networks, the same z / w+ inputs and the same uint8 NHWC
frames as `gance_tpu`. Activations are NCHW and conv weights OIHW. The three
synthesis kernels that `gance_tpu` wrote in Pallas (the noise/bias/lrelu
epilogue, the skip-chain 2x upsample and the post-transpose-conv blur) are
hand-written CUDA under `ops/cuda/csrc/`, built with nvcc at first use.

The package imports torch and never jax or gance_tpu. Entry points run on
`device="cuda"` unless the caller asks for the CPU, where every kernel wrapper
uses its plain PyTorch twin.
"""

__version__ = "0.1.0"

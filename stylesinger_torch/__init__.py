"""StyleSinger in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``stylesinger_tpu`` (JAX).  It imports torch and numpy,
never JAX or the JAX package.  Zero-shot synthesis, from seeded or
trained weights: ``stylesinger_torch.inference.StyleSingerInfer``.
"""

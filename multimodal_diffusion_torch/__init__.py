"""PyTorch + CUDA port of multimodal_diffusion_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (ops/, models/, infer/, media/, utils/) and
names; the JAX package stays the numerical reference. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""

"""EvDeblurNeRF in PyTorch and CUDA: the port of ``evdeblurnerf_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. This slice is the eval/serving render of the c2f PDRF model
(``serving.build_renderer`` -> ``models.system.EvDeblurNeRF.render_chunk``)
with the TPU's Pallas kernels on that path written by hand for Hopper
(``kernels/``, ``csrc/``): K1 ``permute_lanes``, K3 ``cdf_take`` and the
forward of the tri-plane sampler K4. The package imports torch, never jax;
only ``config.py`` reads the JAX package's (jax-free) flag table, so the
serving path loads nothing of the JAX package.
"""

"""EvDeblurNeRF in PyTorch and CUDA: the port of ``evdeblurnerf_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. Ported so far: the eval/serving render of the c2f PDRF model
(``serving.build_renderer`` -> ``models.system.EvDeblurNeRF.render_chunk``)
and the paper's training step (``train.state.create_train_state`` ->
``train.step.build_train_step``), with the TPU's Pallas kernels on those
paths written by hand for Hopper (``kernels/``, ``csrc/``): K1
``permute_lanes`` and its backward launch, K2 ``permute_lanes_3d``, K3
``cdf_take``, the tri-plane sampler's forward K4 and backward K5, and
the line-table gradient K6. The package imports torch, never jax; only
``config.parse_args`` reads the JAX package's (jax-free) flag table, so
the serving and training paths load nothing of the JAX package.
"""

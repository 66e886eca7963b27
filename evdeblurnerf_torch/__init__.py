"""EvDeblurNeRF in PyTorch and CUDA: the port of ``evdeblurnerf_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. Ported so far: the eval/serving render of the c2f PDRF model
(``serving.build_renderer`` -> ``models.system.EvDeblurNeRF.render_chunk``),
the paper's training step (``train.state.create_train_state`` ->
``train.step.build_train_step``, on the card replayed from one CUDA graph
per gate key by ``train.capture.CapturedStep``) and the training run
around it
(``cli.main`` -> ``train.loop.train``: datasets, prefetch, schedules,
checkpoints, held-out renders with LPIPS, resume, render-only, the
``torch.profiler`` trace window; data-parallel, multi-host and over
tensor-parallel tables through ``parallel/``), the exported serving
artifact (``serving.py``), in both field families (the c2f PDRF
voxel fields and the vanilla NeRF MLPs of ``mode=nerf``), with the TPU's
Pallas kernels written by hand for Hopper (``kernels/``, ``csrc/``): K1
``permute_lanes`` and its backward launch, K2 ``permute_lanes_3d``, K3
``cdf_take``, the tri-plane sampler's forward K4 and backward K5, the
line-table gradient K6, and the tiled plane gather K7 behind its bench
entry point. The package imports torch, never jax, and nothing of the JAX
package: it keeps its own copies of the host modules it shares a design
with (the flag table, the data layer, pose and event utilities), each
under its counterpart's path.
"""

"""PyTorch/CUDA port of the underwater image restoration system.

The serving path of SpectralTransformer runs here: uint8 NHWC images are
normalized on the device, go through the model in NCHW, and come back as
float NHWC in [-1, 1].  Every SpectralBlock sends its two halves to
hand-written CUDA kernels (``ops.fused_mdta``, ``ops.fused_gdfn``) when its
tensors lie on the GPU, and to their plain PyTorch versions on the CPU.

The training run around the train step (``train.ModelTrainer``: epochs,
validation, checkpoints, resume) and the command line
(``python -m underwater_image_restoration_torch.cli``) run here too.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the
CLI: ``--use-cpu``).
"""

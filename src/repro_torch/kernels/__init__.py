"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``triage``, ``calibrate``, ``framediff``, ``morphology``,
``pixel_cascade``, ``superstep``, ``similarity``), the padding/device
wrappers (``ops``), the bucket table (``buckets``) and the nvcc build
(``runtime``)."""

"""SurveilEdge on PyTorch and CUDA: the port of the ``repro`` JAX package.

Same layout and module names as ``repro``; host-side modules are copies,
and every Pallas kernel on a ported path is a kernel written by hand for
Hopper (``kernels/csrc/``) beside a plain PyTorch version.  The package
imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro``.  Entry point: ``repro_torch.system.run_query(scenario,
device="cuda")``.
"""

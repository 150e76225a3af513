"""nomad_tpu_torch — the PyTorch/CUDA port of ``nomad_tpu``.

A second package beside the JAX one. The host layers it needs
(structs, state store, scheduler, server, pipeline, mock fixtures, the
numpy encoders) are copies of ``nomad_tpu``'s modules at the same
relative paths; the
placement engine's device programs are hand-written CUDA kernels for
Hopper (``tpu/csrc/``), each with a plain PyTorch version beside it
(``tpu/step.py``). The package imports ``torch`` and never ``jax`` or
``nomad_tpu``.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where the plain versions run.
"""

__version__ = "0.1.0"

"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``sim/``,
``scenario/``) and names, so ``repro_torch/core/buzen.py`` is the
counterpart of ``repro/core/buzen.py``.  The port imports ``torch`` and
``numpy`` only — never ``jax`` and nothing of ``repro``; the JAX package
stays the reference it is tested against (``tests/test_torch_*.py``).

Conventions:

  * plain functions on tensors, ``NamedTuple``s of tensors where JAX had
    pytrees, an explicit ``device`` and explicit ``torch.Generator``s;
  * the analysis path is float64 by explicit dtype (torch's global default
    dtype is never changed);
  * entry points that create tensors take ``device=`` and default to
    ``"cuda"``; only a caller that asks for ``device="cpu"`` runs on the CPU;
  * ``vmap`` is a leading lane/batch axis written out and ``scan`` a Python
    loop.  Every Pallas kernel of the slice is a hand-written CUDA kernel
    under ``kernels/csrc`` with a plain PyTorch version beside it (the
    version CPU tensors take).
"""

"""extractorb_tpu_torch — the PyTorch + CUDA port of ``extractorb_tpu``.

The JAX package ``extractorb_tpu`` is the reference; this package keeps its
module layout (``frontend/fast.py`` here is the counterpart of
``extractorb_tpu/frontend/fast.py``, and so on) and its public array
layouts, so the two can be fed the same numpy inputs and compared.

Plain PyTorch does the glue.  The device programs of the per-frame
tracking step are CUDA kernels written by hand for Hopper (``csrc/``),
built with ``nvcc`` into one shared library at first use
(``extractorb_tpu_torch.kernels``).  Every kernel wrapper takes its plain
PyTorch version for tensors on the CPU and launches the kernel (or
raises) for CUDA tensors.

Importing this package imports neither ``jax`` nor ``triton`` nor
``cv2``, and needs no CUDA toolkit.
"""

__version__ = "0.1.0"

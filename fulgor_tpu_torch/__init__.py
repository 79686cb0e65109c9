"""fulgor-tpu-torch: the fulgor-tpu colored de Bruijn graph index on PyTorch
and CUDA.

The package mirrors fulgor_tpu's layout module for module. The host layers
(native C++ build and parsing, numpy codecs, the container format) are
copies of fulgor_tpu's; the device path is PyTorch on CUDA tensors, with
hand-written CUDA C++ kernels for Hopper (sm_90a) under csrc/:

  host  C++    ccdBG construction, parsing, ascii emit -> native/
  host  numpy  bitstream codecs, container, index      -> core/, index.py
               meta/diff/meta-diff re-compression      -> build/color_builder.py
  device CUDA  window prep, dictionary probes, colour  -> ops/, csrc/
               stage (AND, TU, runs, first colours)
  engine       streaming query tools, array API        -> query/engine.py
  scale-out    a grid of cards in one process; pseudo- -> parallel/
               align over processes (gloo barriers)
  CLI          build, color, the host and query tools  -> cli.py

Index files are shared with fulgor_tpu: either package reads what the other
writes. Entry points run on the card ("cuda") unless told otherwise.
"""

__version__ = "0.1.0"

INDEX_VERSION = (1, 0, 0)


def _tune_malloc():
    """Keep glibc from returning large buffers to the kernel (numpy
    allocates >32 MB arrays per batch; re-faulting their pages on every
    free/alloc cycle dominates host pipelines on slow-faulting hosts). Opt
    out with FULGOR_NO_MALLOC_TUNE=1."""
    import ctypes
    import os

    if os.environ.get("FULGOR_NO_MALLOC_TUNE"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except OSError:  # non-glibc platform: nothing to tune
        pass


_tune_malloc()
